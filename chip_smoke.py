"""Bring-up smoke run on the GPU: the main render and train paths, end to end.

    python3 chip_smoke.py           # one card
    python3 chip_smoke.py --four    # the sharded paths on four cards, and only those

One process drives everything (a second JAX process would find the card's
memory taken). It refuses to run without a GPU. Each phase prints one line;
compile time is reported per phase as set-up time. The one-card run covers:

  render     512², 16 bounces through render_progressive(backend="auto")
  cli        the same job through `oclpathtracer_tpu render`, called in-process
  parity     the megakernel against integrators/parity.py on the same LCG
             streams, for each scan (parity, fast, tp)
  adjoint    the adjoint kernel's class gradients against jnp AD of the twin
  train      a few steps of the albedo kernel step, the vertex step and the
             plain AD step (256², 4 bounces, spp 8): finite, falling losses
  big_scene  a procedural scene of a few thousand triangles through "auto"
  timing     each kernel against the plain jnp path it would fall back to
  gpu_tests  the tests marked `gpu`

The last line is {"ok": true, "device": {"platform", "kind", "count"}}; it is
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# Kernel against the plain integrator on the same streams: GPU arithmetic
# (FMA contraction, libdevice sqrt/sin/cos, Triton's division) rounds
# differently from XLA's, and a path whose hit decision flips at a triangle
# edge diverges from there on. So a pixel matches within PIXEL_RTOL/ATOL, and
# at most MAX_MISMATCH of the pixels and MAX_MEAN_REL of the image mean or the
# segment count may differ.
PIXEL_RTOL = PIXEL_ATOL = 1e-3
MAX_MISMATCH = 2e-3
MAX_MEAN_REL = 2e-3
# Adjoint against AD of the twin: summed over every pixel and path, so the
# same divergent paths shift the sums slightly; relative to the largest entry.
GRAD_REL = 1e-2


class Failed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def timed(fn, reps: int = 3) -> float:
    """Median seconds of fn() (which must return device arrays) over reps."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def compare_images(a, b) -> dict:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    bad = np.abs(a - b) > PIXEL_ATOL + PIXEL_RTOL * np.abs(b)
    return {"max_abs": float(np.abs(a - b).max()),
            "mismatch": float(bad.any(axis=-1).mean()),
            "mean_rel": float(abs(a.mean() - b.mean()) / max(abs(b.mean()),
                                                             1e-12))}


def images_agree(stats: dict) -> bool:
    return (stats["mismatch"] <= MAX_MISMATCH
            and stats["mean_rel"] <= MAX_MEAN_REL)


def _cornell():
    from oclpathtracer_tpu.scene import load_cornell_box

    return load_cornell_box()


def _cfg(size, bounces):
    from oclpathtracer_tpu import RenderConfig

    return RenderConfig(width=size, height=size, bounces=bounces)


def _healthy(img, full: bool) -> dict:
    """Finite, non-negative, lit. At 512²/16 bounces also the known look:
    mean ≈ 1.2–1.5 and the light's 30×3 = 90 as the brightest pixels."""
    img = np.asarray(img)
    res = {"mean": float(img.mean()), "max": float(img.max())}
    check(np.isfinite(img).all(), "non-finite pixels")
    check(img.min() >= 0.0, "negative pixels")
    check(res["mean"] > 0.1, f"image too dark: {res}")
    if full:
        check(1.0 < res["mean"] < 1.8 and res["max"] > 80.0,
              f"unexpected image statistics: {res}")
    return res


# ---- phases --------------------------------------------------------------------

def phase_render(size=512, bounces=16, spp=16, full=True) -> dict:
    from oclpathtracer_tpu.render.driver import render_progressive

    scene, cfg = _cornell(), _cfg(size, bounces)
    img = render_progressive(scene, cfg, spp, samples_per_step=spp,
                             backend="auto")
    return _healthy(img, full)


def phase_cli(size=512, bounces=16, spp=16, full=True) -> dict:
    from oclpathtracer_tpu.cli import main as cli_main

    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"cornell_{size}_{bounces}b_{spp}spp.png")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["render", "--width", str(size), "--height", str(size),
                       "--bounces", str(bounces), "--spp", str(spp),
                       "-o", out])
    check(rc == 0, f"cli exit code {rc}")
    m = re.search(r"mean=([0-9.]+)", buf.getvalue())
    check(m is not None, f"no mean in cli output: {buf.getvalue()!r}")
    mean = float(m.group(1))
    check(not full or 1.0 < mean < 1.8, f"cli image mean {mean}")
    return {"mean": mean, "png": os.path.relpath(out, REPO)}


def phase_parity(size=512, bounces=16, spp=1,
                 scans=("parity", "fast", "tp")) -> dict:
    import jax.numpy as jnp

    from oclpathtracer_tpu.integrators.parity import (count_segments_ref,
                                                       render_sample_ref)
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)

    scene, cfg = _cornell(), _cfg(size, bounces)
    ref = sum(np.asarray(render_sample_ref(scene, cfg, f)) for f in range(spp))
    segs_ref = float(count_segments_ref(scene, cfg, jnp.arange(spp)))
    res = {}
    for scan in scans:
        _, table, emi, classes = prepare_scan(scene, scan)
        img, segs = render_samples_pallas_stats(
            table, cfg, 0, spp, scan=scan, emi_const=emi, classes=classes)
        st = compare_images(img, ref)
        st["segs_rel"] = abs(float(segs) - segs_ref) / segs_ref
        res[scan] = st
        check(images_agree(st) and st["segs_rel"] <= MAX_MEAN_REL,
              f"{scan} scan disagrees with the parity integrator: {st}")
    return res


def twin_class_grads(scene, cfg, ct, mat_class, weight, n_frames):
    """jnp-AD gradient of sum(weight · parity-twin frame sum) w.r.t. the class
    attributes (albedo, emissive) — the reference for the adjoint kernel."""
    import jax
    import jax.numpy as jnp

    from oclpathtracer_tpu.integrators.parity import render_sample_ref

    mcj = jnp.asarray(mat_class)

    def loss(ct_):
        mats = scene.materials._replace(albedo=ct_[:, 0:3][mcj],
                                        emissive=ct_[:, 3:6][mcj])
        sc = scene._replace(materials=mats)

        def body(acc, f):
            return acc + render_sample_ref(sc, cfg, f), None

        acc, _ = jax.lax.scan(body, jnp.zeros((cfg.n_pixels, 3), jnp.float32),
                              jnp.arange(n_frames, dtype=jnp.int32))
        return jnp.sum(weight * acc)

    return jax.jit(jax.grad(loss))(ct)[:, 0:6]


def interior_class_table(ct):
    """Strictly positive class attributes: the max(radiance, 0) clamp never
    binds, so the adjoint and AD differentiate the same function."""
    return ct.at[:, 0:3].set(ct[:, 0:3].clip(0.12, 0.95)).at[:, 3:6].add(0.3)


def phase_adjoint(size=256, bounces=4, spp=2) -> dict:
    import jax.numpy as jnp

    from oclpathtracer_tpu.kernels.grad_megakernel import (
        prepare_grad_scene, render_grads_pallas)

    scene, cfg = _cornell(), _cfg(size, bounces)
    table, ct, C, mat_class = prepare_grad_scene(scene)
    ct = interior_class_table(ct)
    w = jnp.asarray(np.random.default_rng(0).normal(
        size=(cfg.n_pixels, 3)).astype(np.float32))
    _, g = render_grads_pallas(table, ct, cfg, 0, spp, C, weight=w)
    g_ad = twin_class_grads(scene, cfg, ct, mat_class, w, spp)
    g, g_ad = np.asarray(g), np.asarray(g_ad)
    rel = float(np.abs(g - g_ad).max() / np.abs(g_ad).max())
    check(np.isfinite(g).all() and rel <= GRAD_REL,
          f"adjoint vs AD: max rel err {rel}")
    return {"max_rel_err": rel, "max_abs_grad": float(np.abs(g_ad).max())}


def _falling(losses, name):
    check(np.isfinite(losses).all(), f"{name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
    return [float(x) for x in losses]


def phase_train(size=256, bounces=4, spp=8, steps=4) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from oclpathtracer_tpu.core import rng
    from oclpathtracer_tpu.diff import (extract_params, make_train_step,
                                        make_vertex_train_step)
    from oclpathtracer_tpu.diff.fast import (ClassParams, extract_class_params,
                                             make_kernel_train_step,
                                             pack_scene_table)
    from oclpathtracer_tpu.diff.inverse import SceneParams, render_spp
    from oclpathtracer_tpu.kernels.grad_megakernel import (
        prepare_grad_scene, render_grads_pallas)
    from oclpathtracer_tpu.kernels.megakernel import (
        render_samples_pallas_stats)

    scene, cfg = _cornell(), _cfg(size, bounces)
    res = {}

    # Albedo kernel step: perturbed class albedo back toward the truth.
    table, ct, C, _ = prepare_grad_scene(scene)
    target = render_grads_pallas(table, ct, cfg, 0, 2 * spp, C,
                                 with_grads=False)[0] / (2 * spp)
    true = extract_class_params(scene)
    params = ClassParams(albedo=jnp.clip(true.albedo + 0.2, 0.0, 1.0),
                         emissive=true.emissive)
    step = make_kernel_train_step(scene, cfg, spp=spp, lr=2e-3)
    losses = []
    for _ in range(steps):
        params, loss = step(params, target, jnp.int32(0))
        losses.append(float(loss))
    res["kernel_albedo"] = _falling(losses, "kernel albedo step")

    # Vertex step: the ceiling light quad shifted in x, pulled back. Its
    # boundary gradient estimates the gradient of the EXPECTED loss (a fixed
    # frame pair's loss is piecewise constant in the vertices), so what must
    # fall is the light's distance from its true place.
    light = jnp.asarray([10, 11])
    vtarget = render_samples_pallas_stats(pack_scene_table(scene), cfg, 0,
                                          2 * spp, scan="parity")[0] / (2 * spp)
    true_v = extract_params(scene, albedo=False, vertices=True).vertices
    vparams = SceneParams(vertices=tuple(
        v.at[light].add(jnp.asarray([0.3, 0.0, 0.0])) for v in true_v))

    def light_err(p):  # mean |x offset| of the light's vertices
        return float(sum(jnp.abs(v[light, 0] - t[light, 0]).mean()
                         for v, t in zip(p.vertices, true_v)) / 3)

    vstep, vinit = make_vertex_train_step(
        scene, cfg, spp, optax.adam(1e-2), interior_spp=0,
        samples_per_edge=48, edge_spp=4, secondary=True,
        secondary_samples_per_edge=16, secondary_spp=2,
        secondary_pixel_stride=4)
    state = vinit(vparams)
    key = rng.make_key(7)
    losses, errs = [], [light_err(vparams)]
    for i in range(steps):
        vparams, state, loss = vstep(vparams, state, vtarget, jnp.int32(i),
                                     key)
        losses.append(float(loss))
        errs.append(light_err(vparams))
    check(np.isfinite(losses).all(), f"vertex step: non-finite loss {losses}")
    res["vertex"] = {"losses": losses, "light_err": _falling(errs,
                                                             "vertex step")}

    # Plain AD step (no kernel): CRN loss against a render of the truth.
    key = rng.make_key(11)
    ptarget = render_spp(scene, cfg, spp, jax.random.fold_in(key, 0))
    true_alb = extract_params(scene, albedo=True).albedo
    pparams = SceneParams(albedo=jnp.clip(true_alb + 0.2, 0.0, 1.0))
    pstep = make_train_step(scene, cfg, spp, lr=3e-3)
    losses = []
    for _ in range(steps):
        pparams, loss = pstep(pparams, ptarget, jnp.int32(0), key)
        losses.append(float(loss))
    res["plain_ad"] = _falling(losses, "plain AD step")
    return res


def phase_big_scene(size=256, bounces=4, spp=4, n_spheres=16,
                    subdivisions=2) -> dict:
    from oclpathtracer_tpu import CameraConfig, RenderConfig
    from oclpathtracer_tpu.render.driver import render_progressive
    from oclpathtracer_tpu.scene.procgen import sphere_field

    scene = sphere_field(n_spheres=n_spheres, subdivisions=subdivisions,
                         seed=2)
    cfg = RenderConfig(width=size, height=size, bounces=bounces,
                       camera=CameraConfig(eye=(0.0, 3.0, 9.0)))
    t0 = time.perf_counter()
    img = render_progressive(scene, cfg, spp, samples_per_step=spp,
                             backend="auto")
    res = _healthy(img, full=False)
    res.update(tris=int(scene.num_triangles),
               seconds_incl_compile=time.perf_counter() - t0)
    return res


def phase_timing(size=512, depths=(4, 16), spp=8, train_size=256,
                 train_bounces=4, train_spp=8, reps=3) -> dict:
    """Each kernel against the plain path it would fall back to, same shapes."""
    import jax
    import jax.numpy as jnp

    from oclpathtracer_tpu.core import rng
    from oclpathtracer_tpu.diff import extract_params, make_train_step
    from oclpathtracer_tpu.diff.fast import (extract_class_params,
                                             make_kernel_train_step)
    from oclpathtracer_tpu.diff.inverse import render_spp
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)
    from oclpathtracer_tpu.render.accumulate import Accumulator
    from oclpathtracer_tpu.render.driver import (make_kernel_render_step,
                                                 make_render_step)

    scene = _cornell()
    key = rng.make_key(0)
    res = {}
    for bounces in depths:
        cfg = _cfg(size, bounces)
        kstep = make_kernel_render_step(scene, cfg, spp)
        jstep = make_render_step(cfg, spp)
        kstep(Accumulator.zeros(cfg.n_pixels), jnp.int32(0))  # compile
        jstep(Accumulator.zeros(cfg.n_pixels), scene, jnp.int32(0), key)
        t_k = timed(lambda: kstep(Accumulator.zeros(cfg.n_pixels),
                                  jnp.int32(0)), reps)
        t_j = timed(lambda: jstep(Accumulator.zeros(cfg.n_pixels), scene,
                                  jnp.int32(0), key), reps)
        scan, table, emi, classes = prepare_scan(scene)
        _, segs = render_samples_pallas_stats(table, cfg, 0, spp, scan=scan,
                                              emi_const=emi, classes=classes)
        res[f"render_{size}_{bounces}b"] = {
            "kernel_ms_per_spp": 1e3 * t_k / spp,
            "jnp_ms_per_spp": 1e3 * t_j / spp,
            "kernel_Msegments_per_s": float(segs) / t_k / 1e6,
            "kernel_faster": t_k < t_j}

    cfg = _cfg(train_size, train_bounces)
    true = extract_class_params(scene)
    kparams = true._replace(albedo=jnp.clip(true.albedo + 0.2, 0.0, 1.0))
    ktarget = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    kstep = make_kernel_train_step(scene, cfg, spp=train_spp, lr=1e-3)
    pparams = extract_params(scene, albedo=True, emissive=True)
    pstep = make_train_step(scene, cfg, train_spp, lr=1e-3)
    ptarget = render_spp(scene, cfg, train_spp, key)
    jax.block_until_ready(kstep(kparams, ktarget, jnp.int32(0)))
    jax.block_until_ready(pstep(pparams, ptarget, jnp.int32(0), key))
    t_k = timed(lambda: kstep(kparams, ktarget, jnp.int32(0)), reps)
    t_p = timed(lambda: pstep(pparams, ptarget, jnp.int32(0), key), reps)
    res[f"albedo_step_{train_size}_{train_bounces}b_spp{train_spp}"] = {
        "adjoint_kernel_ms": 1e3 * t_k, "jnp_ad_ms": 1e3 * t_p,
        "kernel_faster": t_k < t_p}
    return res


def phase_gpu_tests() -> dict:
    import pytest

    os.environ["OCLPT_TESTS_ON_GPU"] = "1"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests")])
    tail = buf.getvalue().strip().splitlines()[-1:]
    check(rc == 0, f"gpu tests: pytest exit code {rc}: {buf.getvalue()}")
    return {"summary": tail[0] if tail else ""}


def phase_four(size=512, bounces=16, spp=4, train_size=256, train_bounces=4,
               train_spp=8) -> dict:
    """The sharded paths on four cards against the same work on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from oclpathtracer_tpu.core import rng
    from oclpathtracer_tpu.diff import extract_params, make_sharded_train_step
    from oclpathtracer_tpu.diff.fast import (extract_class_params,
                                             make_kernel_train_step,
                                             make_sharded_kernel_train_step)
    from oclpathtracer_tpu.diff.inverse import make_loss_fn, render_spp
    from oclpathtracer_tpu.kernels.megakernel import (prepare_scan,
                                                      render_samples_pallas)
    from oclpathtracer_tpu.parallel.mesh import default_mesh
    from oclpathtracer_tpu.parallel.sharded import (render_progressive_sharded,
                                                    shard_pixels)
    from oclpathtracer_tpu.parallel.sharded_pallas import render_pallas_sharded
    from oclpathtracer_tpu.render.driver import render_progressive

    devs = jax.devices()
    check(len(devs) >= 4, f"need 4 devices, have {len(devs)}")
    mesh = default_mesh(devs, n=4)
    scene = _cornell()
    res = {}

    # Kernel render: the same Triton kernel per card on absolute pixel ids →
    # bitwise the one-card image.
    cfg = _cfg(size, bounces)
    scan, table, emi, classes = prepare_scan(scene)
    img4 = np.asarray(render_pallas_sharded(scene, cfg, mesh, spp))
    img1 = np.asarray(render_samples_pallas(table, cfg, 0, spp, scan=scan,
                                            emi_const=emi,
                                            classes=classes)) / spp
    res["kernel_render_bitwise"] = bool(np.array_equal(img4, img1))
    check(res["kernel_render_bitwise"],
          f"sharded kernel render differs: {compare_images(img4, img1)}")

    # jnp render: one XLA program per layout, so fusion may round
    # differently — the parity tolerances apply.
    img4 = np.asarray(render_progressive_sharded(scene, cfg, mesh, spp,
                                                 samples_per_step=spp))
    img1 = np.asarray(render_progressive(scene, cfg, spp,
                                         samples_per_step=spp))
    st = compare_images(img4, img1)
    st["bitwise"] = bool(np.array_equal(img4, img1))
    res["jnp_render"] = st
    check(images_agree(st), f"sharded jnp render differs: {st}")

    # Sharded train steps: gradients psum'd in another order → allclose.
    tcfg = _cfg(train_size, train_bounces)
    key = rng.make_key(3)
    target = render_spp(scene, tcfg, train_spp, key) * 0.9
    params = extract_params(scene, albedo=True, emissive=True)
    pix = jax.device_put(shard_pixels(tcfg, mesh), NamedSharding(mesh, P("tiles")))
    tgt = jax.device_put(target, NamedSharding(mesh, P("tiles")))
    step = make_sharded_train_step(scene, tcfg, mesh, train_spp, lr=1.0)
    new, _ = step(params, tgt, pix, jnp.int32(0), key)
    g4 = jax.tree.map(lambda p, n: p - n, params, new)
    g1 = jax.grad(make_loss_fn(scene, tcfg, train_spp))(
        params, target, jax.random.fold_in(key, 0))
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()
                    / max(np.abs(np.asarray(b)).max(), 1e-12))
              for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)))
    res["jnp_train_grad_rel_err"] = err
    check(err <= 1e-3, f"sharded jnp train grads differ: {err}")

    kparams = extract_class_params(scene)
    ktarget = target * 0.7
    p1, l1 = make_kernel_train_step(scene, tcfg, spp=train_spp, lr=1e-2)(
        kparams, ktarget, jnp.int32(0))
    p4, l4 = make_sharded_kernel_train_step(scene, tcfg, mesh, spp=train_spp,
                                            lr=1e-2)(
        kparams, jax.device_put(ktarget, NamedSharding(mesh, P("tiles"))),
        jnp.int32(0))
    err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p4)))
    res["kernel_train_loss"] = [float(l1), float(l4)]
    res["kernel_train_param_max_abs_diff"] = err
    check(abs(float(l1) - float(l4)) <= 1e-5 * abs(float(l1)) and err <= 1e-6,
          f"sharded kernel train step differs: loss {l1} vs {l4}, params {err}")
    return res


ONE_CARD = (("render", phase_render), ("cli", phase_cli),
            ("parity", phase_parity), ("adjoint", phase_adjoint),
            ("train", phase_train), ("big_scene", phase_big_scene),
            ("timing", phase_timing), ("gpu_tests", phase_gpu_tests))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); refusing "
              "to run", file=sys.stderr)
        return 1
    from oclpathtracer_tpu.runtime.cache import register_compile_listener

    print(f"card: {card_line()}", flush=True)
    compile_s = [0.0]  # backend compile seconds, summed per phase as set-up
    register_compile_listener(
        lambda ev, s: compile_s.__setitem__(0, compile_s[0] + s))

    phases = (("four", phase_four),) if args.four else ONE_CARD
    failed = []
    for name, fn in phases:
        c0, t0 = compile_s[0], time.perf_counter()
        try:
            res = fn()
            status = "ok"
        except Exception as e:  # every phase runs; any failure fails the run
            res, status = f"{type(e).__name__}: {e}", "FAILED"
            failed.append(name)
        print(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s, "
              f"compile {compile_s[0] - c0:.1f} s) "
              f"{json.dumps(res, default=str)}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
