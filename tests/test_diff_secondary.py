"""Secondary-visibility (light-rim) vertex-gradient tests.

The round-4 framework documented AREA-LIGHT vertex gradients as wrong: the
light's rim as seen from every bounce vertex is a visibility boundary the
primary edge estimator (diff/edge.py) never samples, and plain AD reads zero
(emission pickup is piecewise constant in the vertices). diff/secondary.py
integrates that rim; these tests pin it to central finite differences of the
CRN loss.

FD methodology (memory of rounds 3-4): move EVERY triangle-soup copy of a
physical vertex together (single-copy motion opens a crack along the quad
diagonal — a kink central FD half-counts); use a LINEAR loss in the image
(a quadratic loss on an spp-averaged MC image adds an O(jump²/spp) staircase
bias to FD); pick eps large enough to sweep hundreds of CRN sample flips.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.core.intersect import intersect_world
from oclpathtracer_tpu.diff import extract_params
from oclpathtracer_tpu.diff.edge import rays_at
from oclpathtracer_tpu.diff.inverse import apply_params, render_spp
from oclpathtracer_tpu.diff.secondary import (
    emissive_tris,
    secondary_boundary_vertex_grads,
)
from oclpathtracer_tpu.scene import load_cornell_box
from oclpathtracer_tpu.scene.types import (
    SPECULAR,
    Geometry,
    Lights,
    Materials,
    Scene,
)

pytestmark = pytest.mark.slow  # full rim-probe batches + CRN FD renders


def _isolation_scene():
    """Diffuse receiver wall in view; emissive quad BEHIND the camera.

    Primary rays can never hit the light, so the primary edge term and plain
    AD are both exactly zero for its vertices — FD of the CRN loss isolates
    the secondary term. Light winding chosen so its pack normal
    (cross(p3−p1, p2−p1)) faces the receiver (front-face visible from the
    wall; backface-cull parity GenerateColors.cl:100)."""
    A, B, C, D = [-6, -3, -2], [6, -3, -2], [6, 8, -2], [-6, 8, -2]
    L1, L2, L3, L4 = [-4, -1, 4.5], [4, -1, 4.5], [4, 6.5, 4.5], [-4, 6.5, 4.5]
    geom = Geometry(
        p1=jnp.asarray([A, C, L1, L3], jnp.float32),
        p2=jnp.asarray([B, D, L3, L1], jnp.float32),
        p3=jnp.asarray([C, A, L2, L4], jnp.float32),
        mat_id=jnp.asarray([0, 0, 1, 1], jnp.int32))
    mats = Materials(albedo=jnp.asarray([[0.7, 0.7, 0.7], [0, 0, 0]], jnp.float32),
                     emissive=jnp.asarray([[0, 0, 0], [5, 5, 5]], jnp.float32),
                     roughness=jnp.asarray([0, 0], jnp.float32),
                     mtype=jnp.asarray([1, 1], jnp.int32))
    lights = Lights(tri_idx=jnp.asarray([2, 3], jnp.int32),
                    area=jnp.asarray([32.0, 32.0], jnp.float32),
                    normal=jnp.asarray([[0, 0, -1], [0, 0, -1]], jnp.float32))
    return Scene(geometry=geom, materials=mats, lights=lights)


def _fd_multi(loss, params, copies, comp, eps, *args):
    def setp(v):
        vs = list(params.vertices)
        for leaf, row in copies:
            vs[leaf] = vs[leaf].at[row, comp].add(v)
        return params._replace(vertices=tuple(vs))

    return (float(loss(setp(eps), *args))
            - float(loss(setp(-eps), *args))) / (2 * eps)


def test_secondary_grads_match_fd_isolation():
    """Isolation scene: estimator == central FD (rtol 0.15) on light-vertex
    coordinates where plain AD and the primary term are identically zero."""
    scene = _isolation_scene()
    cfg = RenderConfig(width=32, height=32, bounces=2)
    spp = 64
    key = rng.make_key(3)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    params = extract_params(scene, albedo=False, vertices=True)
    n = cfg.n_pixels

    def loss(p, t, k):
        img = render_spp(apply_params(scene, p), cfg, spp, k)
        return jnp.sum((img - t) ** 2) / n

    # Plain AD is identically zero on the light's vertices.
    g_ad = jax.grad(loss)(params, target, key)
    for g in g_ad.vertices:
        assert float(np.abs(np.asarray(g)[2:4]).max()) == 0.0

    img = render_spp(scene, cfg, spp, key)
    weight = 2.0 * img / n
    dp = secondary_boundary_vertex_grads(scene, cfg, weight, key,
                                         samples_per_edge=48, spp=8,
                                         delta=0.01)

    # Physical light corners → soup copies; tri2 = (L1, L3, L2),
    # tri3 = (L3, L1, L4).
    VERTS = {"L1": [(0, 2), (1, 3)], "L2": [(2, 2)],
             "L3": [(1, 2), (0, 3)], "L4": [(2, 3)]}
    checked = 0
    for name, comp in [("L1", 0), ("L2", 0), ("L3", 1), ("L3", 2), ("L4", 1)]:
        copies = VERTS[name]
        g_est = sum(float(np.asarray(dp[leaf])[row, comp])
                    for leaf, row in copies)
        g_fd = _fd_multi(loss, params, copies, comp, 0.1, target, key)
        assert abs(g_fd) > 0.5, f"{name}.{comp}: FD suspiciously small {g_fd}"
        assert np.isclose(g_est, g_fd, rtol=0.15), (
            f"{name}.{'xyz'[comp]}: secondary {g_est} vs FD {g_fd}")
        checked += 1
    assert checked == 5


def test_secondary_depth2_improves_fd_match():
    """max_prefix_depth=2: the rim term from SECOND path vertices (floor
    points reached via the wall) is real and the estimator integrates it.
    Measured r5 on this scene (3 bounces, 4-key FD): depth-2 lands within
    ~1-5% of FD on the x-coordinates where depth-1 is ~6-7% short."""
    A, B, C, D = [-6, -3, -2], [6, -3, -2], [6, 8, -2], [-6, 8, -2]
    F1, F2, F3, F4 = [-6, -3, 4.8], [6, -3, 4.8], [6, -3, -2], [-6, -3, -2]
    L1, L2, L3, L4 = [-4, -1, 4.5], [4, -1, 4.5], [4, 6.5, 4.5], [-4, 6.5, 4.5]
    geom = Geometry(
        p1=jnp.asarray([A, C, F1, F3, L1, L3], jnp.float32),
        p2=jnp.asarray([B, D, F2, F4, L3, L1], jnp.float32),
        p3=jnp.asarray([C, A, F3, F1, L2, L4], jnp.float32),
        mat_id=jnp.asarray([0, 0, 0, 0, 1, 1], jnp.int32))
    mats = Materials(albedo=jnp.asarray([[0.7, 0.7, 0.7], [0, 0, 0]],
                                        jnp.float32),
                     emissive=jnp.asarray([[0, 0, 0], [5, 5, 5]], jnp.float32),
                     roughness=jnp.asarray([0, 0], jnp.float32),
                     mtype=jnp.asarray([1, 1], jnp.int32))
    lights = Lights(tri_idx=jnp.asarray([4, 5], jnp.int32),
                    area=jnp.asarray([32.0, 32.0], jnp.float32),
                    normal=jnp.asarray([[0, 0, -1], [0, 0, -1]], jnp.float32))
    scene = Scene(geometry=geom, materials=mats, lights=lights)

    cfg = RenderConfig(width=32, height=32, bounces=3)
    spp = 96
    n = cfg.n_pixels
    params = extract_params(scene, albedo=False, vertices=True)
    weight = jnp.full((n, 3), 1.0 / n, jnp.float32)

    def loss(p, k):
        img = render_spp(apply_params(scene, p), cfg, spp, k)
        return jnp.sum(img) / n

    dps = {}
    for depth in (1, 2):
        dps[depth] = secondary_boundary_vertex_grads(
            scene, cfg, weight, rng.make_key(3), samples_per_edge=48, spp=6,
            delta=0.01, max_prefix_depth=depth)

    VERTS = {"L1": [(0, 4), (1, 5)], "L2": [(2, 4)], "L4": [(2, 5)]}
    keys = [rng.make_key(k) for k in (3, 17, 99)]
    for name, comp in (("L1", 0), ("L2", 0), ("L4", 1)):
        copies = VERTS[name]
        g1, g2 = (sum(float(np.asarray(dps[d][leaf])[row, comp])
                      for leaf, row in copies) for d in (1, 2))
        g_fd = float(np.mean([_fd_multi(loss, params, copies, comp, 0.1, k)
                              for k in keys]))
        assert abs(g_fd) > 0.1
        assert np.isclose(g2, g_fd, rtol=0.15), (
            f"{name}: depth-2 {g2} vs FD {g_fd}")
        assert abs(g2 - g1) > 1e-3, "depth 2 added nothing — loop inert?"


def test_cornell_light_vertex_grads_match_fd(scene):
    """The round-4 documented-wrong case: Cornell AREA-LIGHT vertex gradients.

    Loss = linear image sum over pixels that see neither the light directly
    nor a near-mirror surface (the two documented estimator restrictions:
    masked-light pixels carry the PRIMARY rim term instead, and roughness-
    0.008 receivers hide the rim inside a delta lobe). What remains is the
    pure diffuse secondary term. FD is averaged over 3 CRN keys (its own
    key-to-key spread is ~15% here — measured r5)."""
    cfg = RenderConfig(width=32, height=32, bounces=2)
    spp = 128
    n = cfg.n_pixels
    params = extract_params(scene, albedo=False, vertices=True)
    assert emissive_tris(scene) == (10, 11)

    pids = jnp.arange(n, dtype=jnp.int32)
    coords = jnp.stack([(pids % cfg.width).astype(jnp.float32) + 0.5,
                        (pids // cfg.width).astype(jnp.float32) + 0.5], -1)
    o, d = rays_at(coords, cfg)
    rec = intersect_world(o, d, scene.geometry)
    hit_light = rec.hit & ((rec.tri_idx == 10) | (rec.tri_idx == 11))
    hit_spec = rec.hit & (scene.materials.mtype[rec.mat_id] == SPECULAR)
    m = np.asarray(hit_light | hit_spec).reshape(cfg.height, cfg.width)
    for _ in range(2):
        m = (m | np.roll(m, 1, 0) | np.roll(m, -1, 0)
             | np.roll(m, 1, 1) | np.roll(m, -1, 1))
    umask = jnp.asarray(~m.reshape(-1))[:, None].astype(jnp.float32)

    def loss(p, k):
        img = render_spp(apply_params(scene, p), cfg, spp, k)
        return jnp.sum(img * umask) / n

    weight = jnp.broadcast_to(umask, (n, 3)) / n
    dp = secondary_boundary_vertex_grads(scene, cfg, weight, rng.make_key(3),
                                         samples_per_edge=64, spp=2,
                                         delta=0.01)

    # Light quad corners → soup copies: tri10 = (Q1, Q2, Q3),
    # tri11 = (Q3, Q4, Q1)  (quad split RaytraceTest.cpp:186-193).
    VERTS = {"Q1": [(0, 10), (2, 11)], "Q2": [(1, 10)],
             "Q3": [(2, 10), (0, 11)], "Q4": [(1, 11)]}
    keys = [rng.make_key(k) for k in (3, 17, 99, 123)]
    checked = 0
    for name, comp in [("Q1", 0), ("Q2", 0), ("Q1", 2)]:
        copies = VERTS[name]
        g_est = sum(float(np.asarray(dp[leaf])[row, comp])
                    for leaf, row in copies)
        g_fd = float(np.mean([_fd_multi(loss, params, copies, comp, 0.15, k)
                              for k in keys]))
        assert abs(g_fd) > 0.05, f"{name}: FD suspiciously small {g_fd}"
        assert np.isclose(g_est, g_fd, rtol=0.2), (
            f"{name}.{'xyz'[comp]}: secondary {g_est} vs 4-key FD {g_fd}")
        checked += 1
    assert checked == 3
