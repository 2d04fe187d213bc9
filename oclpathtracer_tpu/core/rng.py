"""Random number generation.

Two samplers:

1. **Counter-based threefry (default).** This design keys every uniform draw
   by (base seed, sample index, absolute pixel id). That makes sample streams bitwise
   reproducible regardless of sharding layout, batch order, or device count — the
   north-star requirement (SURVEY.md §7 hard-part 4). The reference cannot do this:
   its RNG is stateful-sequential per pixel.

2. **Reference-parity LCG.** An exact uint32 reimplementation of the reference's
   stateful generator (seed init GenerateColors.cl:308 + hashUInt32 :47-59;
   getRandomFloat :61-71) so integrators can reproduce the reference's sample streams
   bit-for-bit when parity testing demands it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Reference-parity LCG (functional: state in, state out)
# ---------------------------------------------------------------------------

_U32 = jnp.uint32


def ref_hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """hashUInt32 — the live branch is a plain LCG (GenerateColors.cl:57)."""
    x = x.astype(_U32)
    return (_U32(1103515245) * x + _U32(12345)).astype(_U32)


def ref_seed(pixel_id: jnp.ndarray, frame_idx: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel stream seed: gid + hashUInt32(frame) (GenerateColors.cl:308)."""
    return (pixel_id.astype(_U32) + ref_hash_u32(frame_idx)).astype(_U32)


def ref_next_float(state: jnp.ndarray):
    """One draw of the reference getRandomFloat (GenerateColors.cl:61-71).

    Wang-hash scramble followed by an LCG step; the *post*-LCG state is converted
    to float via u32 * 2^-32. Returns (new_state, f32 in [0, 1)).

    Delegates to kernels/rng.next_float — the SAME code runs inside Pallas kernel
    bodies, which keeps the jnp parity integrator and the megakernel bit-identical.
    """
    from oclpathtracer_tpu.kernels import rng as krng

    return krng.next_float(state.astype(_U32))


# ---------------------------------------------------------------------------
# Counter-based threefry sampler (default)
# ---------------------------------------------------------------------------


def make_key(seed: int) -> jax.Array:
    return jax.random.key(seed)


def sample_key(key: jax.Array, sample_idx: jnp.ndarray) -> jax.Array:
    """Key for one progressive sample (frame)."""
    return jax.random.fold_in(key, sample_idx)


def pixel_uniforms(skey: jax.Array, pixel_ids: jnp.ndarray, n: int) -> jnp.ndarray:
    """(len(pixel_ids), n) uniforms keyed by absolute pixel id.

    `pixel_ids` are ABSOLUTE ids (y*width+x of the full image), never shard-local,
    so any tiling/sharding of the image produces the identical sample set.
    """
    keys = jax.vmap(lambda pid: jax.random.fold_in(skey, pid))(pixel_ids)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=jnp.float32))(keys)
