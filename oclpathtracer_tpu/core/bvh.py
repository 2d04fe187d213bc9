"""Flattened BVH — build (host, numpy) and reference traversal (jnp).

The reference intersects by brute-force linear scan over all triangles
(intersectWorld, GenerateColors.cl:137-154) — fine for its 36 triangles, hopeless
beyond. The north star (BASELINE.json) mandates the upgrade: a flattened BVH laid
out for a kernel to walk.

Layout: pre-order depth-first with SKIP LINKS — stackless traversal (SURVEY.md §7
hard-part 2):

  * node i's first child is i+1 (pre-order); `skip[i]` is the node visited when the
    subtree rooted at i is culled — traversal is `i = hit ? i+1 : skip[i]`, one
    scalar induction variable, no stack;
  * leaves store a contiguous [tri_start, tri_start+tri_count) range into a
    REORDERED triangle array, so leaf tests are dense loops.

`intersect_bvh` is the vmap reference traversal; no GPU traversal kernel exists
yet (the linear megakernel serves every scene size).

Build: top-down binned SAH (16 bins over the longest centroid axis, surface-area
cost SA_L·N_L + SA_R·N_R, median-split fallback for degenerate distributions).
The builder is host-side numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from oclpathtracer_tpu.scene.types import Geometry


class FlatBVH(NamedTuple):
    """Flattened BVH as jnp arrays (a pytree; replicable across the mesh).

    nodes_min/max: (N, 3) f32 — node AABBs
    skip:          (N,) i32  — next node when this subtree is culled (N = end)
    tri_start:     (N,) i32  — leaf: first triangle in the REORDERED order; -1 internal
    tri_count:     (N,) i32  — leaf: triangle count; 0 for internal nodes
    order:         (T,) i32  — reordered-tri -> original-tri index map
    """

    nodes_min: jnp.ndarray
    nodes_max: jnp.ndarray
    skip: jnp.ndarray
    tri_start: jnp.ndarray
    tri_count: jnp.ndarray
    order: jnp.ndarray

    @property
    def num_nodes(self) -> int:
        return self.skip.shape[0]


_SAH_BINS = 16


def _sah_split(idxs: np.ndarray, centroid: np.ndarray,
               tri_min: np.ndarray, tri_max: np.ndarray):
    """Binned-SAH split of `idxs`; returns (left_idxs, right_idxs).

    Evaluates 16 uniform centroid bins on the longest centroid axis; the split
    minimizing SA(L)·N(L) + SA(R)·N(R). Falls back to an exact median split when
    the centroids are degenerate (zero extent) or SAH puts everything on one side.
    """
    c = centroid[idxs]
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    key = c[:, axis]
    lo, hi = float(key.min()), float(key.max())

    def median():
        mid = len(idxs) // 2
        part = np.argpartition(key, mid)
        return idxs[part[:mid]], idxs[part[mid:]]

    if hi - lo < 1e-12:
        return median()

    bins = np.minimum(
        ((key - lo) * (_SAH_BINS / (hi - lo))).astype(np.int64), _SAH_BINS - 1)
    counts = np.bincount(bins, minlength=_SAH_BINS)

    # Per-bin AABBs -> prefix/suffix sweep of surface areas.
    bmin = np.full((_SAH_BINS, 3), np.inf)
    bmax = np.full((_SAH_BINS, 3), -np.inf)
    for a in range(3):
        np.minimum.at(bmin[:, a], bins, tri_min[idxs, a])
        np.maximum.at(bmax[:, a], bins, tri_max[idxs, a])

    def areas(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    nl = np.cumsum(counts)[:-1]                 # tris in bins [0..s]
    nr = len(idxs) - nl
    cost = areas(lmin, lmax)[:-1] * nl + areas(rmin, rmax)[1:] * nr
    # Empty-side splits get infinite cost.
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    if not np.isfinite(cost).any():
        return median()
    s = int(np.argmin(cost))
    go_left = bins <= s
    return idxs[go_left], idxs[~go_left]


def build_bvh(geom: Geometry, leaf_size: int = 4, branching: int = 2) -> FlatBVH:
    """Host-side build; returns the flattened pre-order skip-link BVH.

    branching: children per internal node (power of two). The flattened format
    is branching-agnostic (box + skip + leaf range per node); wider trees have
    ~(b-1)/b fewer internal nodes. A b-wide node is built as log2(b) recursive
    binned-SAH splits, so box quality matches the binary tree."""
    p1 = np.asarray(geom.p1, np.float64)
    p2 = np.asarray(geom.p2, np.float64)
    p3 = np.asarray(geom.p3, np.float64)
    n_tris = p1.shape[0]

    tri_min = np.minimum(np.minimum(p1, p2), p3)
    tri_max = np.maximum(np.maximum(p1, p2), p3)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(n_tris)

    # Recursive build into python lists, then flatten.
    nodes_min, nodes_max, skips, starts, counts = [], [], [], [], []

    def emit(idxs: np.ndarray) -> int:
        """Emit subtree for triangles `idxs` (positions in `order` space); returns
        the emitted node id."""
        nid = len(nodes_min)
        bmin = tri_min[idxs].min(axis=0)
        bmax = tri_max[idxs].max(axis=0)
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        skips.append(-1)     # patched after subtree emitted
        starts.append(-1)
        counts.append(0)

        if len(idxs) <= leaf_size:
            starts[nid] = emit.tri_cursor
            counts[nid] = len(idxs)
            emit.reordered.extend(idxs.tolist())
            emit.tri_cursor += len(idxs)
        else:
            # Split into up to `branching` children via recursive SAH
            # splits, largest group first, REPLACED IN PLACE (stable child
            # order). Splitting one group per step keeps the child count
            # exactly ≤ branching.
            groups = [idxs]
            while len(groups) < branching:
                gi_best, sz_best = -1, leaf_size
                for gi, g in enumerate(groups):
                    if len(g) > sz_best:
                        gi_best, sz_best = gi, len(g)
                if gi_best < 0:
                    break  # nothing left to split
                l, r = _sah_split(groups[gi_best], centroid, tri_min, tri_max)
                groups[gi_best:gi_best + 1] = [l, r]
            for g in groups:
                emit(g)
        skips[nid] = len(nodes_min)  # next pre-order node after this subtree
        return nid

    emit.tri_cursor = 0
    emit.reordered = []
    emit(order)

    return FlatBVH(
        nodes_min=jnp.asarray(np.asarray(nodes_min, np.float32)),
        nodes_max=jnp.asarray(np.asarray(nodes_max, np.float32)),
        skip=jnp.asarray(np.asarray(skips, np.int32)),
        tri_start=jnp.asarray(np.asarray(starts, np.int32)),
        tri_count=jnp.asarray(np.asarray(counts, np.int32)),
        order=jnp.asarray(np.asarray(emit.reordered, np.int32)),
    )


def reorder_geometry(geom: Geometry, bvh: FlatBVH) -> Geometry:
    """Geometry permuted into BVH leaf order (dense leaf ranges)."""
    o = bvh.order
    return Geometry(p1=geom.p1[o], p2=geom.p2[o], p3=geom.p3[o],
                    mat_id=geom.mat_id[o])


def _dot(a, b):
    # HIGHEST: a GPU may otherwise run f32 products in TF32 (~3 digits).
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _ray_box_hit(o, inv_d, bmin, bmax, t_best):
    """Slab test: does the ray hit [bmin, bmax] closer than t_best?

    o, inv_d: (..., 3); bmin/bmax broadcastable. Standard robust slab with the
    min/max swap absorbed by taking elementwise min/max of the two plane ts.
    """
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    t_near = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_far = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (t_far >= jnp.maximum(t_near, 0.0)) & (t_near < t_best)


def intersect_bvh_one(o, d, bvh: FlatBVH, rgeom: Geometry, t_max=1e20):
    """Single-ray stackless traversal (jnp while_loop) — the correctness reference
    for the Pallas tile traversal. o, d: (3,). Returns (t, tri_idx_in_reordered).
    """
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    n_nodes = bvh.num_nodes

    def cond(c):
        node, t_best, best = c
        return node < n_nodes

    def body(c):
        node, t_best, best = c
        bmin = bvh.nodes_min[node]
        bmax = bvh.nodes_max[node]
        box_hit = _ray_box_hit(o, inv_d, bmin, bmax, t_best)
        count = bvh.tri_count[node]
        is_leaf = count > 0

        def leaf_scan(c2):
            t_best, best = c2
            start = bvh.tri_start[node]

            def tri_body(k, c3):
                t_best, best = c3
                j = start + k
                e1 = rgeom.p2[j] - rgeom.p1[j]
                e2 = rgeom.p3[j] - rgeom.p1[j]
                pvec = jnp.cross(d, e2)
                det = _dot(e1, pvec)
                front = det >= 1e-8
                inv_det = 1.0 / jnp.where(front, det, 1.0)
                tvec = o - rgeom.p1[j]
                u = _dot(tvec, pvec) * inv_det
                qvec = jnp.cross(tvec, e1)
                v = _dot(d, qvec) * inv_det
                t = _dot(e2, qvec) * inv_det
                ok = (front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                      & (t > 0) & (t < t_best))
                return jnp.where(ok, t, t_best), jnp.where(ok, j, best)

            return jax.lax.fori_loop(0, count, tri_body, (t_best, best))

        t_best, best = jax.lax.cond(
            box_hit & is_leaf, leaf_scan, lambda c2: c2, (t_best, best))
        descend = box_hit & ~is_leaf
        node = jnp.where(descend, node + 1, bvh.skip[node])
        return node, t_best, best

    _, t_best, best = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.float32(t_max), jnp.int32(-1)))
    return t_best, best


def intersect_bvh(o, d, bvh: FlatBVH, rgeom: Geometry, t_max=1e20):
    """Batched jnp traversal via vmap (reference path; the fast path is the Pallas
    tile-synchronized kernel). Returns (t (N,), reordered tri idx (N,), hit (N,))."""
    t, idx = jax.vmap(lambda oo, dd: intersect_bvh_one(oo, dd, bvh, rgeom, t_max))(o, d)
    return t, idx, idx >= 0
