"""Scene pytrees (SoA, static shapes — XLA-friendly).

The reference packs scene data into 64-byte AoS records (Triangle/Material structs,
RaytraceTest.cpp:50-76) for OpenCL struct layout. Here we want SoA jnp arrays:
the intersector broadcasts (N rays, T tris) elementwise, so each triangle component
must be a contiguous vector, not an interleaved struct.

All classes are NamedTuples and therefore pytrees: they flow through jit/vmap/grad
and can be donated/sharded leaf-by-leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Material types — reference GenerateColors.cl:3-4
DIFFUSE = 1
SPECULAR = 2


class Geometry(NamedTuple):
    """Triangle soup. Vertices are (T, 3) float32 per corner; `mat_id` indexes Materials.

    The reference stores one material per *quad* while triangles are per-half-quad
    (RaytraceTest.cpp:186-193): both halves of a quad share a mat_id.
    """

    p1: jnp.ndarray  # (T, 3) f32
    p2: jnp.ndarray  # (T, 3) f32
    p3: jnp.ndarray  # (T, 3) f32
    mat_id: jnp.ndarray  # (T,) i32

    @property
    def num_triangles(self) -> int:
        return self.p1.shape[0]


class Materials(NamedTuple):
    """Material table (one entry per source quad, reference RaytraceTest.cpp:191)."""

    albedo: jnp.ndarray     # (M, 3) f32
    emissive: jnp.ndarray   # (M, 3) f32
    roughness: jnp.ndarray  # (M,) f32
    mtype: jnp.ndarray      # (M,) i32 — DIFFUSE | SPECULAR

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]


class Lights(NamedTuple):
    """Emissive-triangle table for next-event estimation (not in the reference —
    the reference has no NEE; this powers the direct-illumination integrator)."""

    tri_idx: jnp.ndarray  # (L,) i32 — indices into Geometry
    area: jnp.ndarray     # (L,) f32 — triangle areas
    normal: jnp.ndarray   # (L, 3) f32 — geometric normal (normalize(cross(e2, e1)))


class Scene(NamedTuple):
    geometry: Geometry
    materials: Materials
    lights: Lights

    @property
    def num_triangles(self) -> int:
        return self.geometry.num_triangles
