"""Fast differentiable rendering: Pallas forward, exact backward via the jnp twin.

The Pallas megakernel has no AD rule (a compiled kernel is opaque to JAX's
autodiff). But the jnp parity integrator (integrators/parity.py) computes the SAME
function of the scene parameters — identical RNG streams, identical math, equal to
float tolerance (pinned by tests/test_kernels.py). So a custom_vjp can run the
kernel on the forward pass and differentiate the twin on the backward pass: the
returned gradient is the true gradient of what the forward computed (up to float
noise), with the forward at kernel speed.

The scene→table packing is reimplemented in jnp (pack_scene_table) so the forward
works on traced parameter values inside jit; its gradient is never needed (the
backward differentiates through apply_params → parity integrator instead).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.diff.inverse import SceneParams, apply_params
from oclpathtracer_tpu.integrators.parity import render_sample_ref
from oclpathtracer_tpu.kernels.megakernel import TABLE_COLS, render_samples_pallas_stats
from oclpathtracer_tpu.scene.types import Scene


def pack_scene_table(scene: Scene) -> jnp.ndarray:
    """jnp mirror of kernels.megakernel.pack_scene (traceable; columns identical)."""
    g, m = scene.geometry, scene.materials
    p1 = g.p1
    e1 = g.p2 - p1
    e2 = g.p3 - p1
    n = jnp.cross(e2, e1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    mid = g.mat_id
    t = scene.num_triangles
    tbl = jnp.zeros((t, TABLE_COLS), jnp.float32)
    tbl = tbl.at[:, 0:3].set(p1)
    tbl = tbl.at[:, 3:6].set(e1)
    tbl = tbl.at[:, 6:9].set(e2)
    tbl = tbl.at[:, 9:12].set(n)
    tbl = tbl.at[:, 12:15].set(m.albedo[mid])
    tbl = tbl.at[:, 15:18].set(m.emissive[mid])
    tbl = tbl.at[:, 18].set(m.roughness[mid])
    tbl = tbl.at[:, 19].set(m.mtype[mid].astype(jnp.float32))
    return tbl


def make_fast_renderer(scene: Scene, cfg: RenderConfig, n_samples: int):
    """render(params, start_sample) → MEAN image over n_samples reference-stream
    frames. Forward: Pallas megakernel. Backward: AD through the jnp twin."""

    def twin(params: SceneParams, start_sample) -> jnp.ndarray:
        sc = apply_params(scene, params)

        def body(acc, f):
            return acc + render_sample_ref(sc, cfg, f), None

        frames = start_sample + jnp.arange(n_samples, dtype=jnp.int32)
        acc, _ = jax.lax.scan(
            body, jnp.zeros((cfg.n_pixels, 3), jnp.float32), frames)
        return acc / n_samples

    @jax.custom_vjp
    def render(params: SceneParams, start_sample):
        sc = apply_params(scene, params)
        img, _ = render_samples_pallas_stats(pack_scene_table(sc), cfg,
                                             start_sample, n_samples)
        return img / n_samples

    def fwd(params, start_sample):
        return render(params, start_sample), (params, start_sample)

    def bwd(res, g):
        params, start_sample = res
        _, vjp_fn = jax.vjp(lambda p: twin(p, start_sample), params)
        (dparams,) = vjp_fn(g)
        return dparams, None

    render.defvjp(fwd, bwd)
    return render, twin


def make_fast_loss_fn(scene: Scene, cfg: RenderConfig, spp: int):
    """Unbiased pairwise loss (see make_unbiased_loss_fn) with kernel forwards.

    Two independent sample sets = two disjoint reference-frame ranges, selected
    by step index: frames [2k·spp, (2k+1)·spp) and [(2k+1)·spp, (2k+2)·spp).
    """
    render, _ = make_fast_renderer(scene, cfg, spp)

    def loss(params: SceneParams, target, step_idx):
        a = render(params, (2 * step_idx) * spp)
        b = render(params, (2 * step_idx + 1) * spp)
        return jnp.mean((a - target) * (b - target))

    return loss


class ClassParams(NamedTuple):
    """Trainable deduplicated material-CLASS attributes (kernel train path).

    The adjoint megakernel (kernels/grad_megakernel.py) differentiates w.r.t.
    the ≤16 material classes its scan tracks; scenes whose records share a
    class train them jointly (the Cornell scene: 5 classes for 18 records).
    """

    albedo: jnp.ndarray    # (C, 3)
    emissive: jnp.ndarray  # (C, 3)


def extract_class_params(scene: Scene) -> "ClassParams":
    from oclpathtracer_tpu.kernels.grad_megakernel import prepare_grad_scene

    _, ct, _, _ = prepare_grad_scene(scene)
    return ClassParams(albedo=ct[:, 0:3], emissive=ct[:, 3:6])


def class_params_to_materials(scene: Scene, params: "ClassParams") -> SceneParams:
    """Broadcast class attrs back to per-material SceneParams (chain-rule map)."""
    from oclpathtracer_tpu.kernels.grad_megakernel import prepare_grad_scene

    _, _, _, mat_class = prepare_grad_scene(scene)
    return SceneParams(albedo=params.albedo[mat_class],
                       emissive=params.emissive[mat_class])


def _kernel_loss_and_grads(scene: Scene, cfg: RenderConfig, spp: int):
    """(params, target, step_idx) → (loss, ClassParams grads) — the adjoint-
    kernel pairwise-loss gradient shared by the SGD/optax/sharded steps."""
    from oclpathtracer_tpu.kernels.grad_megakernel import (
        prepare_grad_scene,
        render_grads_pallas,
    )

    table, ct0, C, _ = prepare_grad_scene(scene)
    n3 = cfg.n_pixels * 3

    def loss_and_grads(params: ClassParams, target, step_idx):
        ct = jnp.concatenate([params.albedo, params.emissive, ct0[:, 6:8]], 1)
        fa = (2 * step_idx) * spp
        fb = (2 * step_idx + 1) * spp
        a, _ = render_grads_pallas(table, ct, cfg, fa, spp, C,
                                   with_grads=False)
        b, _ = render_grads_pallas(table, ct, cfg, fb, spp, C,
                                   with_grads=False)
        a = a / spp
        b = b / spp
        loss = jnp.mean((a - target) * (b - target))
        # d loss / d(frame-SUM image) for each render of the pairwise product.
        w_a = (b - target) / (n3 * spp)
        w_b = (a - target) / (n3 * spp)
        _, ga = render_grads_pallas(table, ct, cfg, fa, spp, C, weight=w_a)
        _, gb = render_grads_pallas(table, ct, cfg, fb, spp, C, weight=w_b)
        g = ga + gb
        return loss, ClassParams(albedo=g[:, 0:3], emissive=g[:, 3:6])

    return loss_and_grads


def _project_class(params: ClassParams) -> ClassParams:
    """Back to the physical domain (albedo ∈ [0,1], emissive ≥ 0) — the
    projection under which the adjoint's right-sided boundary derivative is
    the correct gradient (kernels/grad_megakernel.py clamp note)."""
    return ClassParams(albedo=jnp.clip(params.albedo, 0.0, 1.0),
                       emissive=jnp.maximum(params.emissive, 0.0))


def make_kernel_train_step(scene: Scene, cfg: RenderConfig, spp: int,
                           lr: float):
    """FULLY kernel-speed SGD step — Pallas forward AND hand-derived backward.

    (params: ClassParams, target, step_idx) → (params, loss). Loss is the
    unbiased pairwise form (make_unbiased_loss_fn rationale) on two disjoint
    reference-frame ranges; gradients come from the adjoint megakernel's exact
    path-space derivative (kernels/grad_megakernel.py) — no jnp twin anywhere,
    so the whole step runs at kernel throughput.
    Requires tp_scan_supported(scene); parameter updates never recompile
    (class attrs are a dynamic table input).
    """
    loss_and_grads = _kernel_loss_and_grads(scene, cfg, spp)

    @jax.jit
    def step(params: ClassParams, target, step_idx):
        loss, g = loss_and_grads(params, target, step_idx)
        params = _project_class(ClassParams(
            albedo=params.albedo - lr * g.albedo,
            emissive=params.emissive - lr * g.emissive))
        return params, loss

    return step


def make_kernel_optax_step(scene: Scene, cfg: RenderConfig, spp: int,
                           optimizer):
    """Optimizer-driven kernel train step (any optax.GradientTransformation).

    Returns (step, opt_init) where step(params, opt_state, target, step_idx)
    → (params, opt_state, loss). Same adjoint-kernel gradients as
    make_kernel_train_step; adam-style preconditioning handles the class
    gradient-scale spread (walls see ~100× the gradient of small faces —
    the same reason inverse.make_optax_train_step exists for the jnp path).
    """
    loss_and_grads = _kernel_loss_and_grads(scene, cfg, spp)

    @jax.jit
    def step(params: ClassParams, opt_state, target, step_idx):
        loss, g = loss_and_grads(params, target, step_idx)
        updates, opt_state = optimizer.update(g, opt_state, params)
        params = _project_class(ClassParams(
            albedo=params.albedo + updates.albedo,
            emissive=params.emissive + updates.emissive))
        return params, opt_state, loss

    return step, optimizer.init


def make_sharded_kernel_train_step(scene: Scene, cfg: RenderConfig, mesh,
                                   spp: int, lr: float):
    """make_kernel_train_step over a 'tiles' mesh: pixels shard, class grads psum.

    (params, target_sharded, step_idx) → (params, loss). Same collective
    pattern as inverse.make_sharded_train_step (psum is the only
    communication), with the adjoint kernel running per-shard on absolute
    pixel ids (pid_base), so gradients are layout-invariant.
    """
    from jax.sharding import PartitionSpec as P

    from oclpathtracer_tpu.kernels.grad_megakernel import (
        prepare_grad_scene,
        render_grads_pallas,
    )
    from oclpathtracer_tpu.parallel.mesh import TILE_AXIS

    table, ct0, C, _ = prepare_grad_scene(scene)
    n_dev = mesh.shape[TILE_AXIS]
    if cfg.n_pixels % n_dev != 0:
        raise ValueError(f"{cfg.n_pixels} pixels not divisible by {n_dev}")
    local_n = cfg.n_pixels // n_dev
    n3 = cfg.n_pixels * 3

    def local_step(params: ClassParams, target, step_idx):
        base = jax.lax.axis_index(TILE_AXIS) * local_n
        ct = jnp.concatenate([params.albedo, params.emissive, ct0[:, 6:8]], 1)
        fa = (2 * step_idx) * spp
        fb = (2 * step_idx + 1) * spp
        a, _ = render_grads_pallas(table, ct, cfg, fa, spp, C,
                                   with_grads=False, pid_base=base,
                                   n_rays=local_n)
        b, _ = render_grads_pallas(table, ct, cfg, fb, spp, C,
                                   with_grads=False, pid_base=base,
                                   n_rays=local_n)
        a = a / spp
        b = b / spp
        # psum(local sum) / (n_pixels*3) == the single-device jnp.mean loss.
        loss = jax.lax.psum(jnp.sum((a - target) * (b - target)), TILE_AXIS) / n3
        w_a = (b - target) / (n3 * spp)
        w_b = (a - target) / (n3 * spp)
        _, ga = render_grads_pallas(table, ct, cfg, fa, spp, C, weight=w_a,
                                    pid_base=base, n_rays=local_n)
        _, gb = render_grads_pallas(table, ct, cfg, fb, spp, C, weight=w_b,
                                    pid_base=base, n_rays=local_n)
        g = jax.lax.psum(ga + gb, TILE_AXIS)
        albedo = jnp.clip(params.albedo - lr * g[:, 0:3], 0.0, 1.0)
        emissive = jnp.maximum(params.emissive - lr * g[:, 3:6], 0.0)
        return ClassParams(albedo=albedo, emissive=emissive), loss

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)
