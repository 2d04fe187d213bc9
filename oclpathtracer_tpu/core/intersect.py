"""Ray–triangle intersection (Möller–Trumbore), batched over rays × triangles.

Semantics match the reference intersector (intersectTriangle,
GenerateColors.cl:89-135) including its quirks:

  * the determinant test `det < 1e-8f || -det > 1e-8f` reduces to `det < 1e-8`
    → BACKFACES ARE CULLED (GenerateColors.cl:100, SURVEY.md §2.2);
  * the returned normal is normalize(cross(e2, e1)) — the barycentric weighting at
    GenerateColors.cl:130 sums to the same vector;
  * nearest-hit selection scans in triangle order with a strict `t < best`
    (intersectWorld, GenerateColors.cl:137-154) ≡ first-argmin.

Design: instead of the reference's per-ray sequential scan, we broadcast
(N rays × T triangles) and reduce with argmin — a pure vector computation XLA
fuses with no divergence. The Pallas kernels in `kernels/` run the same math per
lane.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from oclpathtracer_tpu.scene.types import Geometry

DET_EPS = 1e-8  # GenerateColors.cl:100
T_MAX = 1e20    # initial hit distance, GenerateColors.cl:139
# np (not jnp): a module-scope jnp scalar would initialize the XLA backend at
# import time, which breaks jax.distributed.initialize in multi-process use
# (it must run before any backend-touching call — parallel/multihost.py).
_BIG = np.float32(3e38)


class HitRecord(NamedTuple):
    """SoA hit record over a ray batch."""

    hit: jnp.ndarray      # (N,) bool
    t: jnp.ndarray        # (N,) f32 (garbage where ~hit)
    point: jnp.ndarray    # (N, 3) f32
    normal: jnp.ndarray   # (N, 3) f32 — geometric normal normalize(cross(e2, e1))
    tri_idx: jnp.ndarray  # (N,) i32
    mat_id: jnp.ndarray   # (N,) i32


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def intersect_tris(o: jnp.ndarray, d: jnp.ndarray, geom: Geometry, t_max=T_MAX):
    """All-pairs candidate hits.

    o, d: (N, 3). Returns (valid (N, T) bool, t (N, T) f32) with invalid → +BIG.
    """
    e1 = geom.p2 - geom.p1  # (T, 3)
    e2 = geom.p3 - geom.p1  # (T, 3)

    # pvec = cross(dir, e2): (N, T, 3)
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = _dot(e1[None, :, :], pvec)  # (N, T)
    # Reference accepts only det >= 1e-8 (backface cull), GenerateColors.cl:100.
    front = det >= DET_EPS
    inv_det = 1.0 / jnp.where(front, det, 1.0)

    tvec = o[:, None, :] - geom.p1[None, :, :]  # (N, T, 3)
    u = _dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = _dot(d[:, None, :], qvec) * inv_det
    t = _dot(e2[None, :, :], qvec) * inv_det

    valid = (
        front
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0) & (t < t_max)
    )
    return valid, jnp.where(valid, t, _BIG)


def intersect_world(o: jnp.ndarray, d: jnp.ndarray, geom: Geometry,
                    t_max=T_MAX) -> HitRecord:
    """Nearest hit over the whole scene for a ray batch (o, d: (N, 3))."""
    valid, t_all = intersect_tris(o, d, geom, t_max)
    tri = jnp.argmin(t_all, axis=-1).astype(jnp.int32)  # first min ≡ reference scan
    n = o.shape[0]
    rows = jnp.arange(n)
    t = t_all[rows, tri]
    hit = valid[rows, tri]

    p1 = geom.p1[tri]
    e1 = geom.p2[tri] - p1
    e2 = geom.p3[tri] - p1
    nrm = jnp.cross(e2, e1)  # reference normal orientation, GenerateColors.cl:123
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)

    point = o + d * t[:, None]
    return HitRecord(
        hit=hit,
        t=t,
        point=point,
        normal=nrm,
        tri_idx=tri,
        mat_id=geom.mat_id[tri],
    )


def occluded(o: jnp.ndarray, d: jnp.ndarray, geom: Geometry, t_max) -> jnp.ndarray:
    """Any-hit query for shadow rays (N,). `t_max` may be scalar or (N,).

    Not present in the reference (no NEE); uses the same cull semantics so shadow
    tests agree with what the camera can see.
    """
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (o.shape[0],))
    valid, _ = intersect_tris(o, d, geom, t_max_b[:, None])
    return jnp.any(valid, axis=-1)
