"""Progressive render driver.

The reference drives 10,000 one-sample kernel launches from the host with a full
clFinish stall after each (RaytraceTest.cpp:250-268) — the per-frame sync is its
single biggest structural performance bug (SURVEY.md §3.3). Here the sample loop is a
`lax.scan` INSIDE one jitted step: the host dispatches once per S-sample chunk and
the device never round-trips in between. The accumulator is donated, so progressive
state updates in place in HBM.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.integrators.path import render_sample
from oclpathtracer_tpu.render.accumulate import Accumulator
from oclpathtracer_tpu.render import checkpoint as ckpt
from oclpathtracer_tpu.scene.types import Scene


def make_render_step(cfg: RenderConfig, samples_per_step: int,
                     sample_fn: Optional[Callable] = None):
    """Build a jitted step: (Accumulator, Scene, start_sample, key) → Accumulator.

    `sample_fn(scene, cfg, sample_idx, key) -> (radiance, stats)` defaults to the
    full path integrator. The accumulator is donated (in-place HBM update).
    """
    fn = sample_fn or render_sample

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(acc: Accumulator, scene: Scene, start_sample, key):
        def body(a, s):
            radiance, _ = fn(scene, cfg, s, key)
            return a.add(radiance), None

        samples = start_sample + jnp.arange(samples_per_step, dtype=jnp.int32)
        acc, _ = jax.lax.scan(body, acc, samples)
        return acc

    return step


def make_kernel_render_step(scene: Scene, cfg: RenderConfig,
                            samples_per_step: int, scan: str = "auto"):
    """Build a jitted step (Accumulator, start_sample) → Accumulator over the
    fused megakernel (kernels/megakernel.py) — the "auto" backend at every
    scene size. scan ∈ {auto, parity, fast, tp}: auto uses the fastest scan
    the scene's materials support (megakernel.resolve_scan). Kernel sample
    streams are the reference's RNG keyed by absolute (pixel, sample) —
    `seed`/`key` have no effect here.
    """
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)

    scan, table, emi, classes = prepare_scan(scene, scan)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(acc: Accumulator, start_sample):
        img, _ = render_samples_pallas_stats(table, cfg, start_sample,
                                             samples_per_step, scan=scan,
                                             emi_const=emi, classes=classes)
        return acc.add_sum(img, samples_per_step)

    return step


def render_progressive(scene: Scene, cfg: RenderConfig, total_spp: int,
                       seed: Optional[int] = None,
                       samples_per_step: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0,
                       sample_fn: Optional[Callable] = None,
                       progress: Optional[Callable[[int], None]] = None,
                       backend: str = "jnp", scan: str = "auto"):
    """Render `total_spp` samples progressively; returns the linear mean image (N, 3).

    Resumes from `checkpoint_path` if it exists (SURVEY.md §5.4: the accumulator +
    sample counter IS the checkpoint — tiny, exact restart at any sample).

    backend: "jnp" (default; the lax.scan megakernel in integrators/path.py, uses
    `seed`) or "auto", the fused megakernel (see
    make_kernel_render_step; reference RNG streams, `seed` ignored). sample_fn
    forces the jnp path. scan: triangle-scan arithmetic for the kernel backend
    ("auto"/"parity"/"fast"/"tp" — see make_kernel_render_step).
    """
    spb = samples_per_step or max(cfg.samples_per_batch, 1)
    key = rng.make_key(cfg.seed if seed is None else seed)

    start = 0
    acc = Accumulator.zeros(cfg.n_pixels)
    if checkpoint_path:
        loaded = ckpt.load(checkpoint_path)
        if loaded is not None:
            acc, start = loaded
    if backend not in ("jnp", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    use_kernel = sample_fn is None and backend == "auto"
    if use_kernel:
        step = make_kernel_render_step(scene, cfg, spb, scan=scan)
    else:
        step = make_render_step(cfg, spb, sample_fn)

    s = start
    while s < total_spp:
        if use_kernel:
            acc = step(acc, jnp.int32(s))
        else:
            acc = step(acc, scene, jnp.int32(s), key)
        s += spb
        if checkpoint_path and checkpoint_every and (s % checkpoint_every == 0):
            ckpt.save(checkpoint_path, acc, s)
        if progress is not None:
            progress(s)
    acc = jax.block_until_ready(acc)
    if checkpoint_path:
        ckpt.save(checkpoint_path, acc, s)
    return acc.mean()
