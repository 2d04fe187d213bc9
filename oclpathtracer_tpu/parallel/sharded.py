"""Tile-sharded progressive rendering via shard_map.

Each device renders an interleaved strip of ABSOLUTE pixel ids (shard i owns pixels
[i*chunk, (i+1)*chunk)); the scene is replicated; no communication happens in the
forward render at all — assembly of the full image is a layout, not a collective.
Sample streams are sharding-invariant because the RNG keys on absolute pixel id
(core/rng.py, SURVEY.md §7 hard-part 4).

The reference comparison point: it cannot do any of this (single device, single
queue — SURVEY.md §2.3); this module is where the multi-card scaling lives.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.integrators.path import render_sample
from oclpathtracer_tpu.parallel.mesh import TILE_AXIS
from oclpathtracer_tpu.render.accumulate import Accumulator
from oclpathtracer_tpu.scene.types import Scene


def padded_pixel_count(n_pixels: int, n_dev: int) -> int:
    """n_pixels rounded up to a multiple of n_dev (the sharded array length)."""
    return ((n_pixels + n_dev - 1) // n_dev) * n_dev


def shard_pixels(cfg: RenderConfig, mesh: Mesh) -> jnp.ndarray:
    """Absolute pixel ids laid out for sharding over 'tiles'.

    Length = n_pixels rounded UP to a multiple of n_devices (pad-and-mask,): tail entries repeat the last pixel id, so padded lanes
    redundantly re-render one real pixel (absolute-id RNG keeps them bitwise
    identical to it) and assembly simply drops the tail —
    render_progressive_sharded slices mean()[:n_pixels]. For the canonical
    512×512 on power-of-two meshes the pad is empty and this is exactly
    arange(n_pixels).
    """
    n_dev = mesh.shape[TILE_AXIS]
    n_pad = padded_pixel_count(cfg.n_pixels, n_dev)
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    return jnp.minimum(ids, cfg.n_pixels - 1)


def make_sharded_render_step(cfg: RenderConfig, mesh: Mesh, samples_per_step: int,
                             sample_fn: Optional[Callable] = None):
    """Jitted (Accumulator, Scene, start_sample, key) → Accumulator over the mesh.

    The accumulator's pixel axis is sharded over 'tiles'; Scene/key replicate. The
    scan over samples runs entirely on-device per shard — zero collectives.
    """
    fn = sample_fn or render_sample

    def local_step(acc_sum, acc_count, scene, pixel_ids, start_sample, key):
        # Everything in here sees the LOCAL pixel shard but ABSOLUTE ids.
        def body(carry, s):
            a_sum = carry
            radiance, _ = fn(scene, cfg, s, key, pixel_ids=pixel_ids)
            return a_sum + radiance, None

        samples = start_sample + jnp.arange(samples_per_step, dtype=jnp.int32)
        acc_sum, _ = jax.lax.scan(body, acc_sum, samples)
        return acc_sum, acc_count + samples_per_step

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(TILE_AXIS), P(), P(), P(TILE_AXIS), P(), P()),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(acc: Accumulator, scene: Scene, pixel_ids, start_sample, key):
        s, c = sharded(acc.sum, acc.count, scene, pixel_ids, start_sample, key)
        return Accumulator(sum=s, count=c)

    return step


def render_progressive_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                               total_spp: int, samples_per_step: int = 16,
                               seed: Optional[int] = None,
                               sample_fn: Optional[Callable] = None) -> jnp.ndarray:
    """Progressive render across the mesh; returns the full linear mean image."""
    key = rng.make_key(cfg.seed if seed is None else seed)
    pixel_ids = jax.device_put(
        shard_pixels(cfg, mesh), jax.NamedSharding(mesh, P(TILE_AXIS))
    )
    # Accumulate over the PADDED pixel space (pad-and-mask: see shard_pixels);
    # the tail duplicates the last pixel and is dropped at assembly.
    acc = Accumulator.zeros(int(pixel_ids.shape[0]))
    acc = Accumulator(
        sum=jax.device_put(acc.sum, jax.NamedSharding(mesh, P(TILE_AXIS))),
        count=jax.device_put(acc.count, jax.NamedSharding(mesh, P())),
    )
    step = make_sharded_render_step(cfg, mesh, samples_per_step, sample_fn)

    s = 0
    while s < total_spp:
        acc = step(acc, scene, pixel_ids, jnp.int32(s), key)
        s += samples_per_step
    acc = jax.block_until_ready(acc)
    return acc.mean()[:cfg.n_pixels]
