"""Kernel-speed inverse rendering: recover material-CLASS attributes with the
adjoint megakernel (kernels/grad_megakernel.py) — Pallas forward AND backward.

Unlike examples/inverse_albedo.py (jnp AD — flexible, differentiates anything),
this is the production training path: gradients w.r.t. the scene's deduplicated material classes
(5 for the Cornell scene), parameter updates never recompile.

Run:  python examples/train_kernel.py  [--steps 60] [--size 128] [--spp 8]
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.diff.fast import (
    ClassParams,
    extract_class_params,
    make_kernel_train_step,
)
from oclpathtracer_tpu.kernels.grad_megakernel import (
    prepare_grad_scene,
    render_grads_pallas,
)
from oclpathtracer_tpu.runtime import enable_compilation_cache
from oclpathtracer_tpu.scene import load_cornell_box


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-2)
    args = ap.parse_args()

    enable_compilation_cache()
    scene = load_cornell_box()
    cfg = RenderConfig(width=args.size, height=args.size, bounces=args.bounces)
    table, ct, C, _ = prepare_grad_scene(scene)

    # Target at the TRUE class attributes (late frame range — disjoint from
    # every training step's sample frames).
    img, _ = render_grads_pallas(table, ct, cfg, 1_000_000, args.target_spp, C,
                                 with_grads=False)
    target = img / args.target_spp

    # Perturb albedo; emissive starts true but stays trainable (the step
    # projects it back to >= 0 each update).
    true_params = extract_class_params(scene)
    params = ClassParams(
        albedo=jnp.clip(true_params.albedo + 0.25, 0.0, 1.0),
        emissive=true_params.emissive,
    )
    err0 = float(np.abs(np.asarray(params.albedo)
                        - np.asarray(true_params.albedo)).mean())

    step = make_kernel_train_step(scene, cfg, args.spp, lr=args.lr)
    for i in range(args.steps):
        params, loss = step(params, target, jnp.int32(i))
        if i % 10 == 0 or i == args.steps - 1:
            err = float(np.abs(np.asarray(params.albedo)
                               - np.asarray(true_params.albedo)).mean())
            emi_err = float(np.abs(np.asarray(params.emissive)
                                   - np.asarray(true_params.emissive)).mean())
            print(f"step {i:3d}  loss {float(loss):10.4f}  "
                  f"|albedo err| {err:.4f}  |emissive err| {emi_err:.3f}")

    err1 = float(np.abs(np.asarray(params.albedo)
                        - np.asarray(true_params.albedo)).mean())
    print(f"class-albedo error: {err0:.4f} -> {err1:.4f}")


if __name__ == "__main__":
    main()
