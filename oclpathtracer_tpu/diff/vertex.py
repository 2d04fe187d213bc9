"""Kernel-speed VERTEX training — Pallas forwards AND Pallas boundary probes.

The adjoint megakernel covers albedo/emissive training, but vertex gradients
need the edge estimators' L_in/L_out radiance probes and forward renders. On
the all-jnp path both go through the plain integrator. This module assembles
the vertex step from kernel-speed parts:

  * forward renders: the fused megakernel on a jnp-packed (traceable) parity
    table — vertex updates flow into the table without re-tracing
    (diff/fast.pack_scene_table);
  * boundary terms: diff/edge.py (primary) + diff/secondary.py (secondary
    light rim) with their radiance probes routed through the megakernel's
    arbitrary-ray entry (megakernel.trace_rays_pallas_stats) via the
    probe_fn hooks;
  * interior terms: AD through the jnp twin — the one part with no kernel
    adjoint (geometry terms do not factor through the mask product the
    adjoint kernel tracks) — at a REDUCED sample count `interior_spp`.
    For pure-diffuse scenes this term is identically zero per-sample
    (radiance is piecewise constant in the vertices: f·cosθ/pdf = albedo
    exactly for the cosine-sampled diffuse lobe), so `interior_spp=0` skips
    it; scenes with GGX surfaces keep a small interior_spp for the smooth
    specular-chain terms.

Loss is the unbiased pairwise form on disjoint reference-frame ranges
(diff/fast.make_fast_loss_fn rationale); the boundary weight is
∂loss/∂I = (A + B − 2t)/n3 applied to both renders' expectations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.diff.edge import boundary_vertex_grads, rays_at
from oclpathtracer_tpu.diff.fast import pack_scene_table
from oclpathtracer_tpu.diff.inverse import SceneParams, apply_params
from oclpathtracer_tpu.diff.secondary import (
    emissive_tris,
    secondary_boundary_vertex_grads,
)
from oclpathtracer_tpu.integrators.parity import render_sample_ref
from oclpathtracer_tpu.kernels.megakernel import (
    render_samples_pallas_stats,
    trace_rays_pallas_stats,
)
from oclpathtracer_tpu.scene.types import Scene


def make_kernel_probe_fns(table, cfg: RenderConfig, edge_spp: int,
                          secondary_spp: int, step_idx):
    """(edge_probe, secondary_probe) over the CURRENT traced scene table.

    CRN pairing holds because paired calls share row indices (the kernel's
    streams key on (row, sample)); step_idx decorrelates steps by shifting
    the sample range. The 2^20 offset keeps probe streams disjoint from the
    forward renders' frame range (probe row ids coincide with pixel ids, so
    equal sample indices would correlate the loss weight with the ΔL probes).
    """
    base = jnp.int32(1 << 20) + step_idx * jnp.int32(1024)

    def edge_probe(coords):
        o, d = rays_at(coords, cfg)
        img, _ = trace_rays_pallas_stats(table, o, d, cfg, edge_spp,
                                         start_sample=base, scan="parity")
        return img / edge_spp

    def secondary_probe(o, d, rem, depth):
        img, _ = trace_rays_pallas_stats(table, o, d,
                                         cfg.with_(bounces=rem),
                                         secondary_spp,
                                         start_sample=base + 512 + depth,
                                         scan="parity")
        return img / secondary_spp

    return edge_probe, secondary_probe


def make_vertex_train_step(scene: Scene, cfg: RenderConfig, spp: int,
                           optimizer, *, interior_spp: int | None = None,
                           samples_per_edge: int = 64, edge_spp: int = 4,
                           delta: float = 0.05, secondary: bool = True,
                           secondary_samples_per_edge: int = 16,
                           secondary_spp: int = 2,
                           secondary_delta: float = 0.01,
                           secondary_depth: int = 1,
                           secondary_pixel_stride: int = 4):
    """Kernel-speed vertex (+ any other leaves) train step.

    Returns (step, opt_init) with step(params, opt_state, target, step_idx,
    key) → (params, opt_state, loss). `interior_spp` (default spp//4, 0 to
    skip) bounds the only jnp-speed part. Requires params.vertices to be set;
    other SceneParams leaves train through the interior term as usual.
    """
    if interior_spp is None:
        interior_spp = max(spp // 4, 1)
    n3 = cfg.n_pixels * 3
    sec_tris = emissive_tris(scene) if secondary else ()

    def twin_pair_loss(params, target, step_idx):
        sc = apply_params(scene, params)

        def mean_frames(first):
            def body(acc, f):
                return acc + render_sample_ref(sc, cfg, f), None

            frames = first + jnp.arange(interior_spp, dtype=jnp.int32)
            acc, _ = jax.lax.scan(
                body, jnp.zeros((cfg.n_pixels, 3), jnp.float32), frames)
            return acc / interior_spp

        a = mean_frames((2 * step_idx) * spp)
        b = mean_frames((2 * step_idx + 1) * spp)
        return jnp.mean((a - target) * (b - target))

    @jax.jit
    def loss_and_grads(params: SceneParams, target, step_idx, key):
        sc = apply_params(scene, params)
        table = pack_scene_table(sc)

        a, _ = render_samples_pallas_stats(table, cfg, (2 * step_idx) * spp,
                                           spp, scan="parity")
        b, _ = render_samples_pallas_stats(table, cfg,
                                           (2 * step_idx + 1) * spp,
                                           spp, scan="parity")
        a = a / spp
        b = b / spp
        loss = jnp.mean((a - target) * (b - target))

        # Interior terms (all leaves) through the jnp twin at interior_spp.
        if interior_spp > 0:
            grads = jax.grad(twin_pair_loss)(params, target, step_idx)
        else:
            grads = jax.tree.map(lambda p: None if p is None
                                 else jnp.zeros_like(p), params,
                                 is_leaf=lambda x: x is None)

        # Boundary terms (vertices) with kernel-speed probes.
        weight = (a + b - 2.0 * target) / n3
        edge_probe, sec_probe = make_kernel_probe_fns(
            table, cfg, edge_spp, secondary_spp, step_idx)
        skey = jax.random.fold_in(key, step_idx)
        dp1, dp2, dp3 = boundary_vertex_grads(
            sc, cfg, weight, skey, samples_per_edge=samples_per_edge,
            spp=edge_spp, delta=delta, probe_fn=edge_probe)
        if sec_tris:
            s1, s2, s3 = secondary_boundary_vertex_grads(
                sc, cfg, weight, skey, tri_idx=sec_tris,
                samples_per_edge=secondary_samples_per_edge,
                spp=secondary_spp, delta=secondary_delta,
                max_prefix_depth=secondary_depth,
                pixel_stride=secondary_pixel_stride, probe_fn=sec_probe)
            dp1, dp2, dp3 = dp1 + s1, dp2 + s2, dp3 + s3
        v1, v2, v3 = grads.vertices
        grads = grads._replace(vertices=(v1 + dp1, v2 + dp2, v3 + dp3))
        return loss, grads

    @jax.jit
    def step(params: SceneParams, opt_state, target, step_idx, key):
        loss, grads = loss_and_grads(params, target, step_idx, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(
            lambda p, u: None if p is None else p + u, params, updates,
            is_leaf=lambda x: x is None)
        return params, opt_state, loss

    return step, optimizer.init
