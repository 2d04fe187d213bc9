"""In-kernel RNG — the reference's exact stateful generator as pure u32 jnp ops.

These functions are plain jax.numpy on uint32 arrays, so the SAME code runs inside
Pallas kernel bodies and in ordinary jitted code — which is
how the Pallas megakernel and the jnp parity integrator (integrators/parity.py)
produce bitwise-identical sample streams.

Semantics (GenerateColors.cl):
  seed     = pixel_id + hashUInt32(frame)            (:308; hashUInt32's live branch
             is the LCG at :57)
  one draw = wang-scramble(state) then LCG step; the post-LCG state is the value
             converted via u32 * 2^-32                (:61-71)

Streams are keyed by (absolute pixel id, frame) — order-independent across
shardings, the reproducibility requirement of SURVEY.md §7 hard-part 4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32


def u32_to_f32(u):
    """float(u) for u: uint32, through two exact 16-bit halves (a form every
    kernel compiler lowers, so kernel and jnp streams stay bitwise equal).

    Split into 16-bit halves: f32(hi)·2^16 is exact (exponent shift of an exact
    ≤16-bit integer), f32(lo) is exact, and the single addition rounds the exact
    sum once — bit-identical to a native round-to-nearest u32→f32 cast (a naive
    int32-reinterpret + 2^32 correction double-rounds and differs by 1 ulp for
    ~6% of values ≥ 2^31)."""
    hi = jax.lax.bitcast_convert_type(u >> 16, jnp.int32).astype(jnp.float32)
    lo = jax.lax.bitcast_convert_type(u & _U32(0xFFFF), jnp.int32).astype(jnp.float32)
    return hi * jnp.float32(65536.0) + lo


def as_u32(x):
    """Reinterpret signed 32-bit as uint32.

    Scalars stay in wrapping int32 arithmetic (two's-complement ≡ u32 for +, *)
    until they combine with a vector; only call this on array values inside
    kernels."""
    x = jnp.asarray(x)
    if x.dtype == _U32:
        return x
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), _U32)


def hash_u32(x):
    """hashUInt32 — LCG form (GenerateColors.cl:57)."""
    return (_U32(1103515245) * as_u32(x) + _U32(12345)).astype(_U32)


def seed_from(pixel_id, frame):
    """Per-pixel stream seed (GenerateColors.cl:308): pixel_id + hash(frame).

    `pixel_id` may be an i32 VECTOR and `frame` an i32 SCALAR (the Pallas case):
    the LCG hash and the add are computed in wrapping int32 — bit-identical to
    u32 — and only the final vector is bitcast to uint32."""
    pid = jnp.asarray(pixel_id)
    f = jnp.asarray(frame)
    if pid.dtype == _U32 and f.dtype == _U32:
        return (pid + hash_u32(f)).astype(_U32)
    h = jnp.int32(1103515245) * f.astype(jnp.int32) + jnp.int32(12345)
    s = pid.astype(jnp.int32) + h
    return jax.lax.bitcast_convert_type(s, _U32)


def next_float(state):
    """(state, u) — one getRandomFloat draw (GenerateColors.cl:61-71)."""
    s = state
    s = (s ^ _U32(61)) ^ (s >> 16)
    s = s + (s << 3)
    s = s ^ (s >> 4)
    s = s * _U32(0x27D4EB2D)
    s = s ^ (s >> 15)
    s = _U32(1103515245) * s + _U32(12345)
    return s, u32_to_f32(s) * jnp.float32(2.3283064365386963e-10)
