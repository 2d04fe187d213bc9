"""Distribution layer — device mesh, tile sharding, collective gradient reduction.

The reference has NO multi-device code (SURVEY.md §2.3: single Device*, single
queue, zero network symbols) — this layer is new design territory. Mapping per
SURVEY.md §5.8:

  * mesh: 1-D `Mesh(('tiles',))` over all cards (every card of a host reaches
    every other over NVLink at the same rate, so the mesh follows the algorithm
    alone; several hosts extend the same axis via jax.distributed.initialize);
  * framebuffer pixels and ray batches shard over 'tiles'; scene geometry and
    material parameters replicate per card;
  * sample streams stay bitwise identical under any layout because every uniform is
    keyed by ABSOLUTE pixel id (core/rng.py), never a shard-local index;
  * parameter gradients all-reduce with jax.lax.psum (the renderer analogue of
    data-parallel gradient sync).
"""

from oclpathtracer_tpu.parallel.mesh import default_mesh, tile_sharding
from oclpathtracer_tpu.parallel.sharded import (
    make_sharded_render_step,
    render_progressive_sharded,
    shard_pixels,
)

__all__ = [
    "default_mesh",
    "tile_sharding",
    "shard_pixels",
    "make_sharded_render_step",
    "render_progressive_sharded",
]
