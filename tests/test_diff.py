"""Differentiable-rendering tests: gradient parity vs finite differences
(BASELINE.json config 5) and sharded-vs-single gradient equivalence.

Common random numbers (fixed key ⇒ fixed sample set) make the rendering loss a
deterministic function of parameters, so central differences are exact up to f32
roundoff — no Monte-Carlo gap between the two estimates.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.diff import (
    SceneParams,
    extract_params,
    make_loss_fn,
    make_sharded_train_step,
    make_train_step,
)
from oclpathtracer_tpu.diff.inverse import render_spp
from oclpathtracer_tpu.parallel.mesh import default_mesh
from oclpathtracer_tpu.parallel.sharded import shard_pixels

CFG = RenderConfig(width=16, height=16, bounces=3)
SPP = 2


def _target(scene):
    key = rng.make_key(7)
    return render_spp(scene, CFG, SPP, key)


def _fd_check(loss, params, grads, leaf_get, leaf_set, idx, eps, rtol, target, key):
    """Central finite difference on one coordinate of one leaf.

    The loss is f32 with magnitude O(100): FD resolution is ~ulp(loss)/eps. The
    absolute tolerance below accounts for that floor; gradients under it are
    indistinguishable from 0 by FD and only sanity-checked for finiteness.
    """
    g_ad = float(leaf_get(grads)[idx])
    assert np.isfinite(g_ad)
    p_plus = leaf_set(params, leaf_get(params).at[idx].add(eps))
    p_minus = leaf_set(params, leaf_get(params).at[idx].add(-eps))
    f_plus = float(loss(p_plus, target, key))
    f_minus = float(loss(p_minus, target, key))
    g_fd = (f_plus - f_minus) / (2 * eps)
    fd_floor = 4.0 * np.spacing(np.float32(max(abs(f_plus), abs(f_minus)))) / (2 * eps)
    if abs(g_ad) > fd_floor:
        assert np.isclose(g_ad, g_fd, rtol=rtol, atol=2 * fd_floor), (
            f"AD {g_ad} vs FD {g_fd} at {idx} (floor {fd_floor})"
        )
    return g_ad


def test_albedo_grads_match_finite_differences(scene):
    key = rng.make_key(3)
    target = _target(scene)
    loss = make_loss_fn(scene, CFG, SPP)
    params = extract_params(scene, albedo=True)
    grads = jax.grad(loss)(params, target, key)

    # Check the LARGEST-gradient coordinates (FD can actually resolve those in
    # f32) plus one small one for the finiteness path.
    g_abs = np.abs(np.asarray(grads.albedo))
    top = np.argsort(g_abs.ravel())[::-1][:3]
    coords = [tuple(np.unravel_index(i, g_abs.shape)) for i in top] + [(0, 0)]
    checked = 0
    for idx in coords:
        g = _fd_check(
            loss, params, grads,
            lambda p: p.albedo, lambda p, v: p._replace(albedo=v),
            idx, eps=2e-3, rtol=0.1, target=target, key=key,
        )
        checked += abs(g) > 0.1
    assert checked >= 2, f"albedo gradients suspiciously small: {g_abs.max()}"


def test_emissive_grads_match_finite_differences(scene):
    key = rng.make_key(3)
    target = _target(scene)
    loss = make_loss_fn(scene, CFG, SPP)
    params = extract_params(scene, albedo=False, emissive=True)
    grads = jax.grad(loss)(params, target, key)

    # The light material: find it from the scene table.
    li = int(np.argmax(np.asarray(scene.materials.emissive).max(axis=-1)))
    _fd_check(
        loss, params, grads,
        lambda p: p.emissive, lambda p, v: p._replace(emissive=v),
        (li, 0), eps=1e-2, rtol=0.05, target=target, key=key,
    )


def _occluder_scene():
    """Synthetic scene whose loss FD is PURE primary boundary term: a black
    (albedo 0) occluder triangle in front of an emissive backdrop. No indirect
    light exists off the occluder, the backdrop's emission is unconditional,
    and its bounce rays can only reach the occluder's backface (culled) — so
    central FD of the loss w.r.t. occluder vertices isolates exactly the
    visibility term diff/edge.py estimates. (The Cornell box's own silhouette
    FDs mix in secondary/shadow terms — the documented bias, see
    test_vertex_grads_cornell_boundary_structure.)"""
    from oclpathtracer_tpu.scene.types import Geometry, Lights, Materials, Scene

    # Backdrop quad at z=-5 and occluder at z=-2, both wound so the pack
    # normal N = cross(e2, e1) faces the camera (N·d ≥ 1e-8 for d ≈ -z).
    A, B, C, D = [-4, -1, -5], [4, -1, -5], [4, 6.5, -5], [-4, 6.5, -5]
    O1, O2, O3 = [-1.0, 1.6, -2.0], [1.2, 2.0, -2.0], [0.1, 4.0, -2.0]
    geom = Geometry(p1=jnp.asarray([A, C, O1], jnp.float32),
                    p2=jnp.asarray([B, D, O2], jnp.float32),
                    p3=jnp.asarray([C, A, O3], jnp.float32),
                    mat_id=jnp.asarray([0, 0, 1], jnp.int32))
    mats = Materials(albedo=jnp.asarray([[1, 1, 1], [0, 0, 0]], jnp.float32),
                     emissive=jnp.asarray([[5, 5, 5], [0, 0, 0]], jnp.float32),
                     roughness=jnp.asarray([0, 0], jnp.float32),
                     mtype=jnp.asarray([1, 1], jnp.int32))
    lights = Lights(tri_idx=jnp.asarray([0], jnp.int32),
                    area=jnp.asarray([30.0], jnp.float32),
                    normal=jnp.asarray([[0, 0, 1]], jnp.float32))
    return Scene(geometry=geom, materials=mats, lights=lights)


@pytest.mark.slow  # 2 full edge-sampled gradients + 6 FD renders
def test_vertex_grads_match_fd_on_silhouette():
    """Edge-aware vertex gradients match central FD on silhouette-moving
    coordinates (BASELINE.json config 5). Plain AD gives
    exactly ZERO here (the occluder is black — no interior term at all), so
    every matched digit comes from the boundary estimator."""
    from oclpathtracer_tpu.diff import make_edge_aware_loss_fn

    scene = _occluder_scene()
    cfg = RenderConfig(width=32, height=32, bounces=2)
    spp = 64
    key = rng.make_key(3)
    target = jnp.zeros((cfg.n_pixels, 3), jnp.float32)
    loss_edge = make_edge_aware_loss_fn(scene, cfg, spp, samples_per_edge=256,
                                        edge_spp=8, delta=0.03)
    loss_plain = make_loss_fn(scene, cfg, spp)
    params = extract_params(scene, albedo=False, vertices=True)
    grads = jax.grad(loss_edge)(params, target, key)
    grads_interior = jax.grad(loss_plain)(params, target, key)

    # Interior term is identically zero for the black occluder.
    for g in grads_interior.vertices:
        assert float(np.abs(np.asarray(g)[2]).max()) == 0.0

    def fd(leaf, comp, eps):
        def setp(v):
            vs = list(params.vertices)
            vs[leaf] = vs[leaf].at[2, comp].add(v)
            return params._replace(vertices=tuple(vs))

        return (float(loss_plain(setp(eps), target, key))
                - float(loss_plain(setp(-eps), target, key))) / (2 * eps)

    # The three largest silhouette movers (x/y translations of the occluder's
    # corners — each moves a different projected edge pair).
    mags = [(leaf, comp, abs(float(np.asarray(grads.vertices[leaf])[2, comp])))
            for leaf in range(3) for comp in range(2)]
    mags.sort(key=lambda t: -t[2])
    checked = 0
    # eps = 0.08 world ≈ 0.36 px at the occluder's depth: enough CRN sample
    # flips (~200) that FD's discreteness noise sits under the tolerance,
    # while the expected loss stays near-linear (straight-edge sweep).
    for leaf, comp, mag in mags[:3]:
        g_ad = float(np.asarray(grads.vertices[leaf])[2, comp])
        g_fd = fd(leaf, comp, 0.08)
        assert np.isclose(g_ad, g_fd, rtol=0.1), (
            f"vertex p{leaf+1}[occ,{comp}]: AD {g_ad} vs FD {g_fd}")
        checked += 1
    assert checked == 3


@pytest.mark.slow  # 108-edge boundary quadrature on the full Cornell scene
def test_vertex_grads_cornell_boundary_structure(scene):
    """Cornell-scene structure checks of the boundary term (full FD parity is
    pinned on the synthetic scene above; here FD mixes in secondary/shadow
    terms — the documented bias, diff/edge.py): finite everywhere, nonzero on
    the light's rim (the dominant visible discontinuity), and exactly zero for
    the tall box's BACKFACING top face (front-face cull — moving an invisible
    face must not leak its neighbors' silhouette jump)."""
    from oclpathtracer_tpu.diff import boundary_vertex_grads

    cfg = RenderConfig(width=32, height=32, bounces=2)
    key = rng.make_key(3)
    weight = jnp.full((cfg.n_pixels, 3), 1.0 / cfg.n_pixels, jnp.float32)
    dp1, dp2, dp3 = boundary_vertex_grads(scene, cfg, weight, key,
                                          samples_per_edge=64, spp=4)
    for g in (dp1, dp2, dp3):
        assert np.isfinite(np.asarray(g)).all()
    # Light rim (tris 10-11) x-translation: dominant discontinuity, nonzero.
    assert abs(float(dp1[10, 0])) + abs(float(dp2[10, 0])) > 1e-3
    # Tall-box top face (tris 26-27) is backfacing from the camera: culled.
    for g in (dp1, dp2, dp3):
        np.testing.assert_array_equal(np.asarray(g)[26], 0.0)
        np.testing.assert_array_equal(np.asarray(g)[27], 0.0)


def _with_spec_roughness(scene, r):
    from oclpathtracer_tpu.scene.types import SPECULAR

    rough = jnp.where(scene.materials.mtype == SPECULAR, r,
                      scene.materials.roughness)
    return scene._replace(materials=scene.materials._replace(roughness=rough))


def test_roughness_grads_match_fd_direct(scene):
    """GGX roughness gradients (SceneParams.roughness)
    match central FD through the NEE/direct estimator, where the lobe is
    EVALUATED at the sampled light direction and hence smooth in roughness.
    (Through the BRDF-sampling path estimator the weight is r-independent at
    fixed sampled direction — diff/__init__ documents that restriction.)"""
    from oclpathtracer_tpu.diff.inverse import apply_params
    from oclpathtracer_tpu.integrators.direct import render_direct

    cfg = RenderConfig(width=32, height=32, bounces=2)
    n = cfg.n_pixels
    key = rng.make_key(3)
    for r0, rtol in ((0.25, 0.1), (0.05, 0.2)):
        sc = _with_spec_roughness(scene, r0)
        params = extract_params(sc, albedo=False, roughness=True)
        target = render_direct(sc, cfg, rng.make_key(7), spp=8) * 0.9

        def loss(p, t, k):
            img = render_direct(apply_params(sc, p), cfg, k, spp=8)
            return jnp.sum((img - t) ** 2) / n

        g = float(jax.grad(loss)(params, target, key).roughness[17])
        eps = r0 * 0.05
        p_p = params._replace(roughness=params.roughness.at[17].add(eps))
        p_m = params._replace(roughness=params.roughness.at[17].add(-eps))
        fd = (float(loss(p_p, target, key))
              - float(loss(p_m, target, key))) / (2 * eps)
        assert abs(fd) > 1e-5, f"r0={r0}: FD too small to resolve ({fd})"
        assert np.isclose(g, fd, rtol=rtol), f"r0={r0}: AD {g} vs FD {fd}"


@pytest.mark.slow  # 80 jitted train steps on the direct integrator
def test_roughness_recovery_direct(scene):
    """Inverse rendering recovers the specular mesh's roughness through the
    direct-lighting loss: a 0.2-roughness target is recovered from a 0.5
    start (and the reference's 0.008, below this resolution's distinguishing
    power, trains monotonically toward the near-mirror floor — measured r5)."""
    import optax

    from oclpathtracer_tpu.diff.inverse import apply_params
    from oclpathtracer_tpu.integrators.direct import render_direct

    cfg = RenderConfig(width=32, height=32, bounces=2)
    n = cfg.n_pixels
    sc = _with_spec_roughness(scene, 0.2)
    target = render_direct(sc, cfg, rng.make_key(7), spp=16)
    params = extract_params(sc, albedo=False, roughness=True)
    params = params._replace(roughness=jnp.where(
        sc.materials.mtype == 2, 0.5, sc.materials.roughness))

    def loss_fn(p, key):
        img = render_direct(apply_params(sc, p), cfg, key, spp=8)
        return jnp.sum((img - target) ** 2) / n

    opt = optax.adam(2e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state, key):
        l, g = jax.value_and_grad(loss_fn)(params, key)
        up, state = opt.update(g, state, params)
        params = params._replace(
            roughness=jnp.clip(params.roughness + up.roughness, 1e-4, 1.0))
        return params, state, l

    key = rng.make_key(11)
    for i in range(80):
        params, state, _ = step(params, state, jax.random.fold_in(key, i))
    r = float(params.roughness[17])
    assert abs(r - 0.2) < 0.07, f"recovered roughness {r}, true 0.2"


def test_train_step_reduces_loss(scene):
    """Perturb albedo, run SGD steps, loss must drop toward the true scene."""
    key = rng.make_key(11)
    target = _target(scene)
    true_params = extract_params(scene, albedo=True)
    params = SceneParams(albedo=jnp.clip(true_params.albedo + 0.2, 0.0, 1.0))

    # Gradients are O(10-100) against a loss of O(300): SGD needs a small lr.
    # The loss floor (~225 here) is the irreducible MC mismatch between the
    # 2-spp target (key 7) and the 2-spp render (key 11) — not zero.
    step = make_train_step(scene, CFG, SPP, lr=3e-3)
    losses = []
    for i in range(15):
        params, l = step(params, target, jnp.int32(0), key)  # fixed sample set
        losses.append(float(l))
    assert np.isfinite(losses).all(), f"loss diverged: {losses}"
    assert losses[-1] < losses[0] * 0.85, f"loss did not drop: {losses}"


def test_sharded_grads_match_single_device(scene, cpu_devices):
    key = rng.make_key(3)
    target = _target(scene)
    loss = make_loss_fn(scene, CFG, SPP)
    params = extract_params(scene, albedo=True, emissive=True)
    grads_single = jax.grad(loss)(params, target, key)

    mesh = default_mesh(cpu_devices)
    from jax.sharding import NamedSharding, PartitionSpec as P

    pix = jax.device_put(shard_pixels(CFG, mesh), NamedSharding(mesh, P("tiles")))
    tgt = jax.device_put(target, NamedSharding(mesh, P("tiles")))
    step = make_sharded_train_step(scene, CFG, mesh, SPP, lr=1.0)
    # lr=1.0 ⇒ params_new = params - grads: recover sharded grads by subtraction.
    new_params, _ = step(params, tgt, pix, jnp.int32(0), key)
    # step folds step_idx into the key internally; mirror that for the reference.
    skey = jax.random.fold_in(key, 0)
    grads_ref = jax.grad(loss)(params, target, skey)
    g_sharded = jax.tree.map(lambda p, n: p - n, params, new_params)
    for a, b in zip(jax.tree.leaves(g_sharded), jax.tree.leaves(grads_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
