"""Edge-aware (visibility) vertex gradients — the boundary term plain AD misses.

The pixel value is an integral over the pixel footprint, I_p(θ) = ∫_p L(c; θ) dc.
Differentiating w.r.t. vertex positions θ has two parts (Li et al. 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling"):

  dI_p/dθ = ∫_p ∂L/∂θ dc                         (interior — plain AD, diff/inverse.py)
          + ∮_{edges∩p} (L_in − L_out)(v·n̂) dl   (boundary — THIS module)

where the contour runs over the projected triangle edges crossing the pixel,
v = d(screen position of the edge point)/dθ is the edge's screen velocity,
n̂ the outward screen normal of the edge, and L_in/L_out the radiance just
inside/outside the triangle's projection. Plain AD sees only the first term:
visibility is a step function, so silhouette motion (the reference's moving
short-box top edge against the back wall — geometry RaytraceTest.cpp:87-198,
intersection being differentiated GenerateColors.cl:89-135) gets gradient 0
from AD alone. BASELINE.json config 5 names vertex-position gradients
explicitly; this supplies the missing term.

Design notes:
  * NO silhouette classification. The scene is a triangle soup ((p1,p2,p3) per
    triangle are independent trainables — diff/inverse.SceneParams), so EVERY
    edge of EVERY triangle is integrated with a fixed-shape (3T, S) quadrature
    — static shapes, one fused radiance batch, no data-dependent edge lists.
    Edges whose two sides see the same radiance (shared quad diagonals,
    occluded edges, backfacing triangles) contribute ~0 automatically because
    L_in − L_out ≈ 0 there: correctness comes from the estimator, not from a
    divergent classifier. The cost is O(3T·S) radiance pairs, which for
    small scenes is a rounding error next to the forward render.
  * Common random numbers: the ± offset rays of a pair share one uniform
    stream, so off-silhouette pairs cancel exactly and on-silhouette variance
    drops to the true radiance contrast.
  * The screen-velocity pullback is an exact jax.vjp through the pinhole
    projection — no finite differences anywhere in the estimator.

Scope: this module integrates PRIMARY visibility boundaries (camera-visible
silhouettes crossing the pixel footprint). SECONDARY boundaries — the light's
rim as seen from every bounce-path vertex, the term that dominates AREA-LIGHT
vertex gradients (round-4's documented-wrong case) — are integrated by
diff/secondary.py; make_edge_aware_loss_fn sums both (FD parity on Cornell
light coordinates pinned by tests/test_diff_secondary.py). Box-silhouette
coordinates are primary-dominated — AD matches central FD within ~5-10%
(tests/test_diff.py::test_vertex_grads_match_fd_on_silhouette). Remaining
genuine non-estimates, measured: coplanar stacked surfaces (the light sits
0.008 under the ceiling — normal-direction motion through the neighbor plane
is a depth-order discontinuity with no derivative), backfacing-edge motion
(correctly zero after the front-face cull below), and near-mirror receivers
of the secondary term (diff/secondary.py docstring). Albedo / emissive
gradients are exact under plain AD and unaffected.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from oclpathtracer_tpu.config import CameraConfig, RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.core.camera import basis
from oclpathtracer_tpu.integrators.path import (
    UNIFORMS_PER_BOUNCE,
    trace_paths,
)
from oclpathtracer_tpu.scene.types import Scene


def project_to_screen(pts: jnp.ndarray, cfg: RenderConfig):
    """Project world points to CONTINUOUS pixel coordinates.

    Inverts generate_rays (core/camera.py; generateRay GenerateColors.cl:263-288):
    pixel (px, py) covers [px, px+1) × [py, py+1) in the returned coords.
    Returns (c (N, 2) float32, valid (N,) bool — in front of the eye plane).
    """
    cam = cfg.camera
    view, hol, upd = basis(cam)
    eye = jnp.asarray(cam.eye, jnp.float32)
    angle = math.tan(0.5 * math.radians(cam.vfov_degrees))
    aspect = cfg.width / cfg.height
    v = pts - eye
    # HIGHEST: a GPU may otherwise run f32 products in TF32 (~3 digits), which
    # the finite-difference gradient checks would see.
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    t = dot(v, view)
    valid = t > 1e-6
    safe_t = jnp.where(valid, t, 1.0)
    sx = dot(v, hol) / safe_t
    sy = -dot(v, upd) / safe_t
    cx = (sx / (angle * aspect) + 1.0) * (0.5 * cfg.width)
    cy = (sy / angle + 1.0) * (0.5 * cfg.height)
    return jnp.stack([cx, cy], -1), valid


def rays_at(coords: jnp.ndarray, cfg: RenderConfig):
    """Primary rays through CONTINUOUS pixel coords (N, 2) — no jitter.

    Same mapping as core/camera.generate_rays with x+u-0.5+0.5 ≡ coords."""
    cam = cfg.camera
    view, hol, upd = basis(cam)
    eye = jnp.asarray(cam.eye, jnp.float32)
    angle = math.tan(0.5 * math.radians(cam.vfov_degrees))
    aspect = cfg.width / cfg.height
    sx = (2.0 * coords[:, 0] / cfg.width - 1.0) * angle * aspect
    sy = -(1.0 - 2.0 * coords[:, 1] / cfg.height) * angle
    d = sx[:, None] * hol[None, :] - sy[:, None] * upd[None, :] + view[None, :]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.broadcast_to(eye, d.shape), d


def _edge_soa(geometry):
    """Stack the 3T directed edges (A→B, C the opposite vertex).

    Block layout: edges [0:T)=(p1,p2|p3), [T:2T)=(p2,p3|p1), [2T:3T)=(p3,p1|p2)
    — so per-vertex cotangents fold back without any scatter:
    dp1 = Ā[0:T] + B̄[2T:3T], dp2 = Ā[T:2T] + B̄[0:T], dp3 = Ā[2T:3T] + B̄[T:2T].
    """
    p1, p2, p3 = geometry.p1, geometry.p2, geometry.p3
    A = jnp.concatenate([p1, p2, p3], 0)
    B = jnp.concatenate([p2, p3, p1], 0)
    C = jnp.concatenate([p3, p1, p2], 0)
    return A, B, C


def _radiance_at(scene: Scene, cfg: RenderConfig, coords: jnp.ndarray,
                 key: jax.Array, spp: int) -> jnp.ndarray:
    """Mean radiance of `spp` CRN path samples through continuous coords (N, 2).

    The uniform stream is keyed by (key, draw index, row index) — rows at the
    SAME index across two calls with the same key share their stream (the CRN
    property the ± edge pairs rely on)."""
    n = coords.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    o, d = rays_at(coords, cfg)

    def body(acc, i):
        us = rng.pixel_uniforms(rng.sample_key(key, i), ids,
                                UNIFORMS_PER_BOUNCE * cfg.bounces)
        bounce_us = us.reshape(n, cfg.bounces, UNIFORMS_PER_BOUNCE)
        radiance, _ = trace_paths(o, d, scene, bounce_us, cfg)
        return acc + radiance, None

    acc, _ = jax.lax.scan(body, jnp.zeros((n, 3), jnp.float32),
                          jnp.arange(spp, dtype=jnp.int32))
    return acc / spp


@functools.partial(jax.jit, static_argnames=("cfg", "samples_per_edge",
                                             "spp", "delta", "probe_fn"))
def boundary_vertex_grads(scene: Scene, cfg: RenderConfig, weight: jnp.ndarray,
                          key: jax.Array, samples_per_edge: int = 64,
                          spp: int = 8, delta: float = 0.05,
                          probe_fn=None):
    """Boundary term of d(Σ_p w_p · I_p)/d(vertices) — (dp1, dp2, dp3).

    weight: (n_pixels, 3) = ∂loss/∂I per pixel/channel (for make_loss_fn's
    L2/n form that is 2(img − target)/n). samples_per_edge: stratified
    quadrature points per edge. spp: CRN path samples per radiance
    evaluation. delta: screen-space offset (pixels) of the L_in/L_out probes.

    Estimator, per edge sample s on directed edge (A, B):
      c(s) = project((1−s)A + sB);  τ = dc/ds;  dl = |τ|/S
      n̂ ⊥ τ, oriented away from the opposite vertex's projection (outward)
      ΔL = L(c − δn̂) − L(c + δn̂)   (inside − outside)
      coeff = Σ_rgb w_{pixel(c)} · ΔL · dl
      (Ā, B̄) += coeff · ∂(n̂·c)/∂(A, B)   — exact vjp through the projection
    n̂, dl, ΔL, w are values at the current θ (the boundary formula needs the
    normal velocity only), so they carry stop_gradient semantics by
    construction: only the projection is differentiated.
    """
    geom = scene.geometry
    T = geom.p1.shape[0]
    S = samples_per_edge
    E = 3 * T
    A, B, C = _edge_soa(geom)  # (E, 3) each

    s = (jnp.arange(S, dtype=jnp.float32) + 0.5) / S  # (S,)
    # (E, S, 3) sample points; flatten to rows for one fused projection batch.
    P = (1.0 - s)[None, :, None] * A[:, None, :] + s[None, :, None] * B[:, None, :]
    P_flat = P.reshape(E * S, 3)

    c_flat, valid = project_to_screen(P_flat, cfg)

    # FRONT-FACE CULL. The scan culls backfaces (det = d·N < 1e-8 never hits —
    # core/intersect.py ≡ GenerateColors.cl:100), so a backfacing triangle has
    # zero coverage and moving its edges has zero primary-visibility
    # derivative. Without this cull a backfacing edge COINCIDENT with a
    # front-facing silhouette (e.g. a box top face, camera below its plane,
    # sharing its rim with the visible side faces) would collect the side
    # faces' radiance jump and misattribute it (measured 16× overcount on the
    # tall-box top rim). N = cross(e2, e1), the pack_scene_tp orientation.
    nrm_tri = jnp.cross(geom.p3 - geom.p1, geom.p2 - geom.p1)  # (T, 3)
    nrm_edge = jnp.repeat(jnp.tile(nrm_tri, (3, 1)), S, axis=0)  # (E·S, 3)
    _, d_center = rays_at(c_flat, cfg)
    front = jnp.sum(d_center * nrm_edge, -1) >= 1e-8

    # Screen tangent dc/ds via one jvp along the edge direction (B − A).
    edge_dir = jnp.repeat(B - A, S, axis=0)  # (E·S, 3)
    _, tau = jax.jvp(lambda p: project_to_screen(p, cfg)[0],
                     (P_flat,), (edge_dir,))
    tau_norm = jnp.linalg.norm(tau, axis=-1)
    ok = valid & (tau_norm > 1e-8)
    that = tau / jnp.where(ok, tau_norm, 1.0)[:, None]
    nhat = jnp.stack([that[:, 1], -that[:, 0]], -1)
    # Orient outward: away from the triangle interior. The interior's screen
    # direction comes from a jvp along (C − P) AT the edge point, which is
    # defined from P's own (valid) projection — unlike projecting C itself,
    # which is meaningless when the opposite vertex is behind the camera
    # plane and would leave n̂ with an arbitrary sign there.
    opp_dir = jnp.repeat(C, S, axis=0) - P_flat
    _, dcin = jax.jvp(lambda p: project_to_screen(p, cfg)[0],
                      (P_flat,), (opp_dir,))
    inward = jnp.sum(nhat * dcin, -1) > 0.0
    nhat = jnp.where(inward[:, None], -nhat, nhat)

    # Radiance just inside (−δn̂) and outside (+δn̂), CRN-paired. probe_fn
    # ((N, 2) coords → (N, 3) mean radiance; two calls must share streams
    # row-for-row) lets diff/vertex.py route these through the Pallas
    # arbitrary-ray kernel at ~25× the jnp probe speed.
    if probe_fn is None:
        ekey = jax.random.fold_in(key, 0xED6E5)  # decorrelate from the render
        probe = lambda coords: _radiance_at(scene, cfg, coords, ekey, spp)
    else:
        probe = probe_fn
    L_in = probe(c_flat - delta * nhat)
    L_out = probe(c_flat + delta * nhat)

    # Loss weight at the sample's pixel (0 off-image).
    px = jnp.floor(c_flat[:, 0]).astype(jnp.int32)
    py = jnp.floor(c_flat[:, 1]).astype(jnp.int32)
    on_image = ((px >= 0) & (px < cfg.width) & (py >= 0) & (py < cfg.height))
    pid = jnp.clip(py * cfg.width + px, 0, cfg.n_pixels - 1)
    w = jnp.where(on_image[:, None], weight[pid], 0.0)

    dl = tau_norm / S
    coeff = jnp.sum(w * (L_in - L_out), -1) * dl
    coeff = jnp.where(ok & front, coeff, 0.0)

    # Exact velocity pullback: ∂(n̂·c(s; A, B))/∂(A, B) with cotangent coeff.
    def normal_motion(a, b, sv, nh):
        c, _ = project_to_screen(((1.0 - sv) * a + sv * b)[None, :], cfg)
        return jnp.sum(nh * c[0])

    def pull(a, b, sv, nh, co):
        _, vjp = jax.vjp(lambda aa, bb: normal_motion(aa, bb, sv, nh), a, b)
        da, db = vjp(co)
        return da, db

    s_flat = jnp.tile(s, E)
    A_flat = jnp.repeat(A, S, axis=0)
    B_flat = jnp.repeat(B, S, axis=0)
    dA, dB = jax.vmap(pull)(A_flat, B_flat, s_flat, nhat, coeff)
    dA = dA.reshape(E, S, 3).sum(1)
    dB = dB.reshape(E, S, 3).sum(1)

    dp1 = dA[0:T] + dB[2 * T:3 * T]
    dp2 = dA[T:2 * T] + dB[0:T]
    dp3 = dA[2 * T:3 * T] + dB[T:2 * T]
    return dp1, dp2, dp3


def make_edge_aware_loss_fn(scene: Scene, cfg: RenderConfig, spp: int,
                            samples_per_edge: int = 64, edge_spp: int = 8,
                            delta: float = 0.05, secondary: bool = True,
                            secondary_samples_per_edge: int = 32,
                            secondary_spp: int = 4,
                            secondary_delta: float = 0.01,
                            secondary_depth: int = 1,
                            secondary_pixel_stride: int = 1):
    """make_loss_fn whose VERTEX gradients include the visibility boundary terms.

    Same value and same CRN contract as diff.inverse.make_loss_fn (FD of the
    loss stays well-defined); jax.grad additionally returns boundary-corrected
    gradients on params.vertices: the PRIMARY silhouette term (this module)
    plus, when `secondary` is on and the scene has emissive triangles, the
    SECONDARY light-rim term (diff/secondary.py — the shadow/indirect
    boundary every bounce hemisphere sees). Albedo/emissive
    gradients are untouched (plain AD is exact for them). Signature:
    loss(params, target, key).
    """
    from oclpathtracer_tpu.diff.inverse import (
        SceneParams,
        apply_params,
        make_loss_fn,
    )

    base = make_loss_fn(scene, cfg, spp)

    @jax.custom_vjp
    def loss(params, target, key):
        return base(params, target, key)

    def fwd(params, target, key):
        from oclpathtracer_tpu.diff.inverse import render_spp

        img = render_spp(apply_params(scene, params), cfg, spp, key)
        n = img.shape[0]
        val = jnp.sum((img - target) ** 2) / n
        return val, (params, target, key, img)

    def bwd(res, g):
        params, target, key, img = res
        grads = jax.grad(base)(params, target, key)  # interior terms
        if params.vertices is not None:
            n = img.shape[0]
            weight = 2.0 * (img - target) / n  # ∂loss/∂I for the L2/n loss
            cur = apply_params(scene, params)
            dp1, dp2, dp3 = boundary_vertex_grads(
                cur, cfg, weight, key, samples_per_edge=samples_per_edge,
                spp=edge_spp, delta=delta)
            if secondary:
                from oclpathtracer_tpu.diff.secondary import (
                    secondary_boundary_vertex_grads,
                )

                s1, s2, s3 = secondary_boundary_vertex_grads(
                    cur, cfg, weight, key,
                    samples_per_edge=secondary_samples_per_edge,
                    spp=secondary_spp, delta=secondary_delta,
                    max_prefix_depth=secondary_depth,
                    pixel_stride=secondary_pixel_stride)
                dp1, dp2, dp3 = dp1 + s1, dp2 + s2, dp3 + s3
            v1, v2, v3 = grads.vertices
            grads = grads._replace(vertices=(v1 + dp1, v2 + dp2, v3 + dp3))
        grads = jax.tree.map(lambda x: None if x is None else g * x, grads,
                             is_leaf=lambda x: x is None)
        # True target cotangent (∂/∂t Σ(img−t)²/n = 2(t−img)/n), so a caller
        # whose target comes from another differentiable stage gets the right
        # gradient. Key cotangent is float0 — the only valid
        # tangent dtype for integer primals.
        n = img.shape[0]
        return (grads, g * 2.0 * (target - img) / n,
                np.zeros(key.shape, jax.dtypes.float0))

    loss.defvjp(fwd, bwd)
    return loss
