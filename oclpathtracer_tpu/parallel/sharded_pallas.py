"""Tile-sharded rendering with the Pallas megakernel — the fast multi-card path.

parallel/sharded.py shards the jnp integrator (the semantic reference); this module
shards the fused megakernel: each device runs the kernel over its contiguous range
of ABSOLUTE pixel ids (pid_base = axis_index × pixels-per-device), so RNG streams
and therefore images are bitwise identical to the single-device kernel on any mesh
— the same invariance contract, at kernel speed. No collectives in the forward
path; the assembled image is just the sharded output's layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.kernels.megakernel import render_samples_pallas_stats
from oclpathtracer_tpu.parallel.mesh import TILE_AXIS
from oclpathtracer_tpu.scene.types import Scene


def make_sharded_kernel_step(cfg: RenderConfig, mesh: Mesh, n_samples: int,
                             scan: str = "parity",
                             emi_const: tuple = (0.0, 0.0, 0.0),
                             classes: tuple = ()):
    """Jitted (table, start_sample) → (img (n_pixels,3) sharded, segments ()).

    Requires n_pixels divisible by the device count (the canonical 512² image
    divides any power-of-two mesh). scan/emi_const/classes as in
    megakernel.render_samples_pallas_stats (the scan choice is
    layout-invariant: RNG keys on absolute pixel ids either way).
    """
    n_dev = mesh.shape[TILE_AXIS]
    n_pix = cfg.n_pixels
    if n_pix % n_dev != 0:
        raise ValueError(f"{n_pix} pixels not divisible by {n_dev} devices")
    local_n = n_pix // n_dev

    def local_render(table, start_sample):
        base = jax.lax.axis_index(TILE_AXIS) * local_n
        img, segs = render_samples_pallas_stats(
            table, cfg, start_sample, n_samples, pid_base=base,
            n_rays=local_n, scan=scan, emi_const=emi_const, classes=classes)
        return img, jax.lax.psum(segs, TILE_AXIS)

    sharded = jax.shard_map(
        local_render, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def render_pallas_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                          total_spp: int, samples_per_call: int = 0,
                          scan: str = "auto"):
    """Progressive mean image over the mesh via the megakernel."""
    from oclpathtracer_tpu.kernels.megakernel import prepare_scan

    scan, table, emi, classes = prepare_scan(scene, scan)
    table = jax.device_put(table, NamedSharding(mesh, P()))
    chunk = samples_per_call or total_spp
    step = make_sharded_kernel_step(cfg, mesh, chunk, scan=scan, emi_const=emi,
                                    classes=classes)
    acc = None
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        if n != chunk:
            step = make_sharded_kernel_step(cfg, mesh, n, scan=scan,
                                            emi_const=emi, classes=classes)
        img, _ = step(table, jnp.int32(s))
        acc = img if acc is None else acc + img
        s += n
    return acc / total_spp
