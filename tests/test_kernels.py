"""Pallas megakernel tests (interpret mode on CPU; chip_smoke.py runs the compiled
kernels on the GPU).

The exactness anchor: the megakernel consumes the reference's RNG streams
(kernels/rng.py ≡ core/rng.ref_*), so its output must match the jnp parity
integrator (integrators/parity.py) to float tolerance — same math, same draws.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.kernels import rng as krng
from oclpathtracer_tpu.kernels.megakernel import (
    pack_scene,
    render_pallas,
    render_samples_pallas,
)
from oclpathtracer_tpu.integrators.parity import render_sample_ref

CFG = RenderConfig(width=64, height=32, bounces=6)  # 2048 px = 2 blocks


def test_kernel_rng_matches_core_rng():
    pid = jnp.arange(64, dtype=jnp.uint32)
    s_j = jrng.ref_seed(pid, jnp.uint32(7))
    s_k = krng.seed_from(pid, jnp.uint32(7))
    assert np.array_equal(np.asarray(s_j), np.asarray(s_k))
    for _ in range(4):
        s_j, u_j = jrng.ref_next_float(s_j)
        s_k, u_k = krng.next_float(s_k)
        assert np.array_equal(np.asarray(u_j), np.asarray(u_k))


def test_megakernel_matches_parity_integrator(scene):
    table = pack_scene(scene)
    img_k = np.asarray(render_samples_pallas(table, CFG, 0, 1))
    img_j = np.asarray(render_sample_ref(scene, CFG, 0))
    np.testing.assert_allclose(img_k, img_j, rtol=1e-4, atol=1e-4)


def test_trace_rays_kernel_matches_jnp_twin(scene):
    """Arbitrary-ray entry (trace_rays_pallas_stats, rays_input mode): the
    camera prologue is replaced by ray inputs and the stream's first
    draws are bounce 0's — allclose to trace_paths on ref_uniforms(row, s,
    2*bounces), including the row_base CRN offset."""
    from oclpathtracer_tpu.integrators.parity import ref_uniforms
    from oclpathtracer_tpu.integrators.path import trace_paths
    from oclpathtracer_tpu.kernels.megakernel import (
        pack_scene,
        trace_rays_pallas_stats,
    )

    n = 1500  # not a BLOCK multiple: exercises the pad-and-slice path
    cfg = RenderConfig(width=8, height=8, bounces=3)
    # A spread of rays from two origins through the box interior.
    g = np.random.default_rng(0)
    o = np.where((np.arange(n) % 2 == 0)[:, None],
                 np.array([[0.0, 2.75, 4.0]]), np.array([[0.3, 1.0, -1.0]]))
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)

    table = pack_scene(scene)
    img_k, segs = trace_rays_pallas_stats(table, o, d, cfg, 2, row_base=7)

    rows = jnp.arange(n, dtype=jnp.int32) + 7
    img_j = jnp.zeros((n, 3), jnp.float32)
    for s in range(2):
        us = ref_uniforms(rows, s, 2 * cfg.bounces)
        rad, _ = trace_paths(o, d, scene,
                             us.reshape(n, cfg.bounces, 2), cfg)
        img_j = img_j + rad
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_j),
                               rtol=1e-4, atol=1e-4)
    assert float(segs) > n  # multi-bounce: more segments than rays


def test_megakernel_multi_sample_sum(scene):
    table = pack_scene(scene)
    s4 = np.asarray(render_samples_pallas(table, CFG, 0, 4))
    j4 = sum(np.asarray(render_sample_ref(scene, CFG, i)) for i in range(4))
    np.testing.assert_allclose(s4, j4, rtol=1e-4, atol=2e-4)


def test_megakernel_start_sample_offset(scene):
    """Chunked progressive rendering must continue the same frame sequence."""
    table = pack_scene(scene)
    a = np.asarray(render_samples_pallas(table, CFG, 0, 2))
    b = np.asarray(render_samples_pallas(table, CFG, 2, 2))
    ab = np.asarray(render_samples_pallas(table, CFG, 0, 4))
    np.testing.assert_allclose(a + b, ab, rtol=1e-5, atol=1e-5)


def test_render_pallas_driver(scene):
    img = np.asarray(render_pallas(scene, CFG, total_spp=4, samples_per_call=2))
    assert img.shape == (CFG.n_pixels, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0
    assert img.mean() > 0.1  # lit scene


def test_non_block_aligned_image(scene):
    """n_pixels not divisible by 1024 — padding path."""
    cfg = RenderConfig(width=24, height=24, bounces=3)  # 576 px
    table = pack_scene(scene)
    img_k = np.asarray(render_samples_pallas(table, cfg, 0, 1))
    img_j = np.asarray(render_sample_ref(scene, cfg, 0))
    assert img_k.shape == (576, 3)
    np.testing.assert_allclose(img_k, img_j, rtol=1e-4, atol=1e-4)


# ---------------- division-free fast scan ----------------

def _with_second_emitter(s):
    """Cornell + a second light with a DIFFERENT emissive RGB (fails the fast
    scan's shared-baked-emitter encoding; still only 6 material classes, so
    the tp scan supports it)."""
    emi = np.asarray(s.materials.emissive).copy()
    emi = np.concatenate([emi, [[5.0, 1.0, 1.0]]])  # a second, different light
    mats = s.materials._replace(
        emissive=jnp.asarray(emi),
        albedo=jnp.concatenate([s.materials.albedo,
                                s.materials.albedo[:1]]),
        roughness=jnp.concatenate([s.materials.roughness,
                                   s.materials.roughness[:1]]),
        mtype=jnp.concatenate([s.materials.mtype, s.materials.mtype[:1]]))
    return s._replace(materials=mats)


def _with_many_classes(s):
    """Cornell with every material's albedo made distinct (18 classes >
    TP_CLASS_CAP=16 -> tp unsupported) AND two differing emitters (-> fast
    unsupported): the scene that exercises the parity fallback."""
    s2 = _with_second_emitter(s)
    alb = np.asarray(s2.materials.albedo).copy()
    alb[:, 0] = np.linspace(0.05, 0.95, alb.shape[0], dtype=np.float32)
    return s2._replace(materials=s2.materials._replace(albedo=jnp.asarray(alb)))


def test_fast_scan_supported_cornell(scene):
    from oclpathtracer_tpu.kernels.megakernel import (
        fast_scan_supported, resolve_scan, scene_emissive_const,
        tp_scan_supported)

    assert fast_scan_supported(scene)
    assert tp_scan_supported(scene)
    # auto prefers the tp scan on the canonical workload (fastest supported)
    assert resolve_scan(scene, "auto") == "tp"
    assert scene_emissive_const(scene) == (30.0, 30.0, 30.0)


def test_fast_scan_unsupported_falls_back_to_tp(scene):
    """Two emitters with different emissive RGBs can't share the fast scan's
    baked constant; tp carries per-class emissives, so auto resolves tp."""
    from oclpathtracer_tpu.kernels.megakernel import (
        fast_scan_supported, resolve_scan, tp_scan_supported)

    s2 = _with_second_emitter(scene)
    assert not fast_scan_supported(s2)
    assert tp_scan_supported(s2)
    assert resolve_scan(s2, "auto") == "tp"


def test_scan_parity_fallback(scene):
    """>TP_CLASS_CAP material classes + differing emitters fail BOTH encoded
    scans -> the reference-exact parity scan."""
    from oclpathtracer_tpu.kernels.megakernel import (
        fast_scan_supported, material_classes, resolve_scan,
        tp_scan_supported, TP_CLASS_CAP)

    s3 = _with_many_classes(scene)
    classes, _ = material_classes(s3)
    assert len(classes) > TP_CLASS_CAP
    assert not tp_scan_supported(s3)
    assert not fast_scan_supported(s3)
    assert resolve_scan(s3, "auto") == "parity"


# ---------------- triple-product (tp) scan ----------------

def test_material_classes_cornell(scene):
    """Cornell's 18 material records dedupe to 5 classes (white/red/green
    diffuse, gold specular, light) and the index round-trips every record."""
    from oclpathtracer_tpu.kernels.megakernel import material_classes

    classes, idx = material_classes(scene)
    m = scene.materials
    assert len(classes) == 5
    assert idx.shape == (np.asarray(m.albedo).shape[0],)
    for i in range(idx.shape[0]):
        alb, emi, rough, mty = classes[idx[i]]
        np.testing.assert_array_equal(np.asarray(m.albedo)[i], alb)
        np.testing.assert_array_equal(np.asarray(m.emissive)[i], emi)
        assert float(np.asarray(m.roughness)[i]) == rough
        assert float(np.asarray(m.mtype)[i]) == mty


def test_tp_scan_far_origin_unsupported(scene):
    """Geometry far from the world origin fails the tp numeric-extent gate
    (its triple-product forms cancel catastrophically there); auto falls back
    to the fast scan, whose o - p1 subtraction stays exact."""
    from oclpathtracer_tpu.kernels.megakernel import (
        resolve_scan, tp_scan_supported)

    g = scene.geometry
    shift = jnp.asarray([1.0e5, 0.0, 0.0], jnp.float32)
    g2 = g._replace(p1=g.p1 + shift, p2=g.p2 + shift, p3=g.p3 + shift)
    s2 = scene._replace(geometry=g2)
    assert not tp_scan_supported(s2)
    assert resolve_scan(s2, "auto") == "fast"


def test_prepare_scan_explicit_tp_raises(scene):
    """Explicitly requested 'tp'/'fast' on an unsupported scene must raise,
    not render silently wrong."""
    from oclpathtracer_tpu.kernels.megakernel import prepare_scan

    s3 = _with_many_classes(scene)
    with pytest.raises(ValueError, match="tp"):
        prepare_scan(s3, "tp")
    with pytest.raises(ValueError, match="fast"):
        prepare_scan(s3, "fast")
    # auto on the same scene is fine (resolves parity)
    scan, _, _, _ = prepare_scan(s3, "auto")
    assert scan == "parity"


def test_tp_scan_matches_parity_megakernel(scene):
    """The tp scan must agree with the reference-exact parity scan: same
    traced segments (ulp-boundary hit flips possible in principle, absent at
    this resolution/spp) and allclose images."""
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)

    scan, table, emi, classes = prepare_scan(scene, "tp")
    assert scan == "tp" and len(classes) == 5
    img_p, segs_p = render_samples_pallas_stats(pack_scene(scene), CFG, 0, 2,
                                                scan="parity")
    img_t, segs_t = render_samples_pallas_stats(table, CFG, 0, 2, scan="tp",
                                                classes=classes)
    assert abs(float(segs_p) - float(segs_t)) <= 2.0
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_p),
                               rtol=1e-4, atol=1e-4)


def test_tp_scan_second_emitter_shades_per_class(scene):
    """A two-emitter scene (fast-unsupported) renders correctly under tp:
    allclose to the parity scan on the same scene."""
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)

    s2 = _with_second_emitter(scene)
    scan, table, emi, classes = prepare_scan(s2, "auto")
    assert scan == "tp"
    img_p, segs_p = render_samples_pallas_stats(pack_scene(s2), CFG, 0, 1,
                                                scan="parity")
    img_t, segs_t = render_samples_pallas_stats(table, CFG, 0, 1, scan="tp",
                                                classes=classes)
    assert abs(float(segs_p) - float(segs_t)) <= 2.0
    np.testing.assert_allclose(np.asarray(img_t), np.asarray(img_p),
                               rtol=1e-4, atol=1e-4)


def test_fast_scan_matches_parity_megakernel(scene):
    """The division-free scan must agree with the reference-exact parity scan:
    same traced segments (ulp-boundary hit flips are possible in principle but
    do not occur at this resolution/spp) and allclose images."""
    from oclpathtracer_tpu.kernels.megakernel import (
        render_samples_pallas_stats, scene_emissive_const)

    table = pack_scene(scene)
    emi = scene_emissive_const(scene)
    img_p, segs_p = render_samples_pallas_stats(table, CFG, 0, 2, scan="parity")
    img_f, segs_f = render_samples_pallas_stats(table, CFG, 0, 2, scan="fast",
                                                emi_const=emi)
    assert abs(float(segs_p) - float(segs_f)) <= 2.0
    np.testing.assert_allclose(np.asarray(img_f), np.asarray(img_p),
                               rtol=1e-4, atol=1e-4)
