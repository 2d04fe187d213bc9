"""Adjoint megakernel tests (kernels/grad_megakernel.py — kernel-speed backward).

Pins: (a) the dynamic-class forward is bitwise the tp-scan megakernel; (b) the
hand-derived adjoint equals jnp-AD through the parity twin at an interior
parameter point (strictly positive attrs ⇒ the max(rad,0) clamp never binds ⇒
both compute the same derivative); (c) at the true scene's boundary params
(zero attrs) the adjoint is the RIGHT-SIDED derivative — checked against
upward one-sided FD — which is the correct object for projected gradient
descent (see the kernel docstring's clamp note); (d) the kernel train step
reduces loss; (e) the sharded step matches the single-device step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.kernels.grad_megakernel import (
    prepare_grad_scene,
    render_grads_pallas,
)

CFG = RenderConfig(width=16, height=16, bounces=3)


@pytest.fixture(scope="module")
def grad_scene(scene):
    table, ct, C, mat_class = prepare_grad_scene(scene)
    return scene, table, ct, C, mat_class


@pytest.fixture(scope="module")
def weights():
    r = np.random.default_rng(0)
    return jnp.asarray(r.normal(size=(CFG.n_pixels, 3)).astype(np.float32))


def test_forward_bitwise_matches_tp_megakernel(grad_scene):
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan,
        render_samples_pallas_stats,
    )

    scene, table, ct, C, _ = grad_scene
    img1, _ = render_grads_pallas(table, ct, CFG, 0, 2, C, with_grads=False)
    _, t2, emi, classes = prepare_scan(scene, "tp")
    img2, _ = render_samples_pallas_stats(t2, CFG, 0, 2, scan="tp",
                                          emi_const=emi, classes=classes)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


def _twin_grad(scene, mat_class, ct, w, n_frames=2):
    """jnp-AD gradient of sum(w · parity-twin image) w.r.t. class attrs."""
    from oclpathtracer_tpu.integrators.parity import render_sample_ref

    mcj = jnp.asarray(mat_class)

    def loss(ct_):
        mats = scene.materials._replace(albedo=ct_[:, 0:3][mcj],
                                        emissive=ct_[:, 3:6][mcj])
        sc = scene._replace(materials=mats)

        def body(acc, f):
            return acc + render_sample_ref(sc, CFG, f), None

        acc, _ = jax.lax.scan(body, jnp.zeros((CFG.n_pixels, 3), jnp.float32),
                              jnp.arange(n_frames, dtype=jnp.int32))
        return jnp.sum(w * acc)

    return jax.grad(loss)(ct)[:, 0:6]


def test_adjoint_matches_twin_ad_at_interior_point(grad_scene, weights):
    """Strictly positive attrs: every path's radiance is strictly positive in
    every channel, the clamp is inert, and the adjoint must equal reverse-mode
    AD through the bitwise-identical parity twin to float tolerance."""
    scene, table, ct, C, mat_class = grad_scene
    cti = ct.at[:, 0:3].set(jnp.clip(ct[:, 0:3], 0.12, 0.95)).at[:, 3:6].add(0.3)
    _, g = render_grads_pallas(table, cti, CFG, 0, 2, C, weight=weights)
    g_twin = _twin_grad(scene, mat_class, cti, weights)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_twin),
                               rtol=5e-3, atol=5e-3)


def test_adjoint_is_right_derivative_at_boundary(grad_scene, weights):
    """At the true scene's params (many zero attrs) the adjoint equals the
    UPWARD one-sided FD — the derivative projected GD uses at the boundary of
    the physical domain. (Central FD would step emissive/albedo negative,
    cross the max(rad,0) clamp, and read half the slope — see docstring.)"""
    scene, table, ct, C, _ = grad_scene
    w = weights
    _, g = render_grads_pallas(table, ct, CFG, 0, 2, C, weight=w)

    def loss(ct_):
        img, _ = render_grads_pallas(table, ct_, CFG, 0, 2, C,
                                     with_grads=False)
        return float(jnp.sum(w * img))

    l0 = loss(ct)
    # f32 FD resolution floor: ulp(loss)/eps.
    checked = 0
    for c, k, eps in [(0, 0, 1e-3), (0, 4, 1e-3), (1, 3, 1e-3),
                      (2, 1, 1e-3), (3, 0, 1e-3), (4, 2, 1e-3)]:
        e = np.zeros(np.asarray(ct).shape, np.float32)
        e[c, k] = eps
        fd = (loss(ct + e) - l0) / eps
        ad = float(g[c, k])
        floor = 4.0 * float(np.spacing(np.float32(abs(l0)))) / eps
        if abs(ad) > 4 * floor:
            assert np.isclose(ad, fd, rtol=5e-2, atol=2 * floor), (
                f"class {c} attr {k}: AD {ad} vs FD+ {fd} (floor {floor})")
            checked += 1
    assert checked >= 4, "too few resolvable coordinates"


def test_adjoint_semantics_where_clamp_binds(grad_scene, weights):
    """Exercise the adjoint where max(radiance, 0)
    actually BINDS mid-accumulation with nonzero carried state. A class with
    NEGATIVE albedo (outside the physical domain) makes odd-bounce paths
    carry negative masks, so per-sample radiance goes negative and the clamp
    fires. Pins the kernel header's documented semantics: the adjoint is the
    exact derivative of the UNCLAMPED path sum — equal to AD of the unclamped
    twin, and necessarily different from AD of the clamped twin where the
    clamp is active."""
    from oclpathtracer_tpu.core.camera import generate_rays
    from oclpathtracer_tpu.integrators.parity import ref_uniforms
    from oclpathtracer_tpu.integrators.path import trace_paths

    scene, table, ct, C, mat_class = grad_scene
    ctn = ct.at[0, 0:3].set(jnp.asarray([-0.4, -0.3, -0.35]))
    w = weights
    _, g = render_grads_pallas(table, ctn, CFG, 0, 2, C, weight=w)

    mcj = jnp.asarray(mat_class)
    pixel_ids = jnp.arange(CFG.n_pixels, dtype=jnp.int32)

    def twin_image(ct_, clamp):
        mats = scene.materials._replace(albedo=ct_[:, 0:3][mcj],
                                        emissive=ct_[:, 3:6][mcj])
        sc = scene._replace(materials=mats)
        acc = jnp.zeros((CFG.n_pixels, 3), jnp.float32)
        for f in range(2):
            us = ref_uniforms(pixel_ids, f, 2 + 2 * CFG.bounces)
            o, d = generate_rays(pixel_ids % CFG.width, pixel_ids // CFG.width,
                                 CFG.width, CFG.height, us[:, 0], us[:, 1],
                                 CFG.camera)
            rad, _ = trace_paths(o, d, sc,
                                 us[:, 2:].reshape(-1, CFG.bounces, 2), CFG,
                                 clamp=clamp)
            acc = acc + rad
        return acc

    # The clamp genuinely binds: some per-sample radiance is negative.
    assert float(twin_image(ctn, clamp=False).min()) < -1e-3

    g_unclamped = jax.grad(
        lambda c: jnp.sum(w * twin_image(c, False)))(ctn)[:, 0:6]
    g_clamped = jax.grad(
        lambda c: jnp.sum(w * twin_image(c, True)))(ctn)[:, 0:6]
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_unclamped),
                               rtol=5e-3, atol=5e-3)
    diff = float(np.abs(np.asarray(g) - np.asarray(g_clamped)).max())
    assert diff > 1e-2, (
        f"clamp did not separate the two derivatives ({diff}) — the scene "
        f"point no longer activates it")


def test_kernel_train_step_reduces_loss(grad_scene):
    from oclpathtracer_tpu.diff.fast import ClassParams, extract_class_params, \
        make_kernel_train_step

    scene, table, ct, C, _ = grad_scene
    true_params = extract_class_params(scene)
    # Target: render at the TRUE params; start from perturbed albedo.
    img, _ = render_grads_pallas(table, ct, CFG, 0, 4, C, with_grads=False)
    target = img / 4
    params = ClassParams(albedo=jnp.clip(true_params.albedo + 0.2, 0.0, 1.0),
                         emissive=true_params.emissive)
    step = make_kernel_train_step(scene, CFG, spp=2, lr=2e-3)
    losses = []
    for i in range(10):
        params, loss = step(params, target, jnp.int32(0))  # fixed frames
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.7, f"loss did not drop: {losses}"


def test_kernel_optax_step_reduces_loss(grad_scene):
    import optax

    from oclpathtracer_tpu.diff.fast import ClassParams, \
        extract_class_params, make_kernel_optax_step

    scene, table, ct, C, _ = grad_scene
    true_params = extract_class_params(scene)
    img, _ = render_grads_pallas(table, ct, CFG, 0, 4, C, with_grads=False)
    target = img / 4
    params = ClassParams(albedo=jnp.clip(true_params.albedo + 0.2, 0.0, 1.0),
                         emissive=true_params.emissive)
    step, opt_init = make_kernel_optax_step(scene, CFG, spp=2,
                                            optimizer=optax.adam(5e-2))
    opt_state = opt_init(params)
    losses = []
    for i in range(10):
        params, opt_state, loss = step(params, opt_state, target, jnp.int32(0))
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.7, f"loss did not drop: {losses}"
    assert float(jnp.max(params.albedo)) <= 1.0
    assert float(jnp.min(params.emissive)) >= 0.0


def test_sharded_kernel_step_matches_single(grad_scene, cpu_devices):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from oclpathtracer_tpu.diff.fast import extract_class_params, \
        make_kernel_train_step, make_sharded_kernel_train_step
    from oclpathtracer_tpu.parallel.mesh import default_mesh

    scene, table, ct, C, _ = grad_scene
    # 2-device mesh + 2 bounces: the interpret-mode adjoint inside shard_map
    # is a huge XLA CPU program; the invariance it pins is device-count
    # independent (absolute-id RNG), so keep the compile tractable.
    cfg = RenderConfig(width=32, height=32, bounces=2)  # 1024 px / 2 devs
    mesh = default_mesh(cpu_devices, n=2)
    params = extract_class_params(scene)
    img, _ = render_grads_pallas(table, ct, cfg, 0, 2, C, with_grads=False)
    # 0.7x: a target EQUAL to the render makes (a - target) == 0 bitwise and
    # loss == 0 on both paths — which let a 3x loss-normalization bug slip
    # through this assert once. Keep the loss nonzero.
    target = img / 2 * 0.7

    step1 = make_kernel_train_step(scene, cfg, spp=2, lr=1e-2)
    p1, l1 = step1(params, target, jnp.int32(0))

    stepN = make_sharded_kernel_train_step(scene, cfg, mesh, spp=2, lr=1e-2)
    tgt = jax.device_put(target, NamedSharding(mesh, P("tiles")))
    pN, lN = stepN(params, tgt, jnp.int32(0))

    np.testing.assert_allclose(float(l1), float(lN), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(pN)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
