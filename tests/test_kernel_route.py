"""Fast-tier tests of the GPU kernel layer at tiny shapes.

On the CPU the kernels run in the Pallas interpreter through the same Triton-
route `pallas_call`s the GPU compiles (kernels/route.py). Tests marked `gpu`
compile them for the card and skip elsewhere; chip_smoke.py runs them there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.integrators.parity import (count_segments_ref,
                                                   render_sample_ref)
from oclpathtracer_tpu.kernels import route
from oclpathtracer_tpu.kernels.grad_megakernel import (prepare_grad_scene,
                                                       render_grads_pallas)
from oclpathtracer_tpu.kernels.megakernel import (prepare_scan,
                                                  render_samples_pallas_stats,
                                                  trace_rays_pallas_stats)

CFG = RenderConfig(width=16, height=16, bounces=2)
SCANS = ("parity", "fast", "tp")


# ---- route picker ----------------------------------------------------------------

@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu", "rocm"])
def test_route_picker(monkeypatch, platform):
    monkeypatch.setattr(route, "_platform", lambda: platform)
    if platform == "cpu":
        assert route.pallas_params(4) == {"backend": "triton",
                                          "interpret": True}
    elif platform == "gpu":
        p = route.pallas_params(8)
        assert p["backend"] == "triton" and "interpret" not in p
        assert p["compiler_params"].num_warps == 8
    else:
        with pytest.raises(RuntimeError, match="no Pallas route"):
            route.pallas_params(4)


# ---- megakernel against the jnp references ---------------------------------------

@pytest.fixture(scope="module")
def parity_ref(scene):
    img = sum(np.asarray(render_sample_ref(scene, CFG, f)) for f in range(2))
    return img, float(count_segments_ref(scene, CFG, jnp.arange(2)))


@pytest.mark.parametrize("scan", SCANS)
def test_megakernel_matches_parity_integrator(scene, parity_ref, scan):
    """Same LCG streams, same math: equal images and segment counts."""
    _, table, emi, classes = prepare_scan(scene, scan)
    img, segs = render_samples_pallas_stats(table, CFG, 0, 2, scan=scan,
                                            emi_const=emi, classes=classes)
    ref, segs_ref = parity_ref
    assert np.asarray(img).shape == (CFG.n_pixels, 3)
    np.testing.assert_allclose(np.asarray(img), ref, rtol=1e-4, atol=1e-4)
    assert float(segs) == segs_ref


def test_megakernel_block_padding_and_offset(scene):
    """A pixel count that is not a block multiple, and a pid_base/n_rays
    window: the window equals the same rows of the full image."""
    cfg = RenderConfig(width=20, height=15, bounces=2)  # 300 px, 2 blocks
    _, table, emi, classes = prepare_scan(scene, "parity")
    full, _ = render_samples_pallas_stats(table, cfg, 0, 1)
    part, _ = render_samples_pallas_stats(table, cfg, 0, 1, pid_base=100,
                                          n_rays=150)
    ref = np.asarray(render_sample_ref(scene, cfg, 0))
    np.testing.assert_allclose(np.asarray(full), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(part),
                                  np.asarray(full)[100:250])


def test_trace_rays_matches_jnp_twin(scene):
    """Arbitrary-ray entry: camera prologue replaced by ray planes, first draws
    are bounce 0's — equal to trace_paths on ref_uniforms(row, s, 2·bounces),
    including the row_base CRN offset and a non-block-multiple row count."""
    from oclpathtracer_tpu.integrators.parity import ref_uniforms
    from oclpathtracer_tpu.integrators.path import trace_paths
    from oclpathtracer_tpu.kernels.megakernel import pack_scene

    n = 300
    g = np.random.default_rng(0)
    o = np.where((np.arange(n) % 2 == 0)[:, None],
                 np.array([[0.0, 2.75, 4.0]]), np.array([[0.3, 1.0, -1.0]]))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    img, segs = trace_rays_pallas_stats(pack_scene(scene), o, d, CFG, 2,
                                        row_base=7)
    rows = jnp.arange(n, dtype=jnp.int32) + 7
    ref = 0.0
    for s in range(2):
        us = ref_uniforms(rows, s, 2 * CFG.bounces)
        ref = ref + trace_paths(o, d, scene, us.reshape(n, CFG.bounces, 2),
                                CFG)[0]
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert float(segs) > n


def test_kernel_backend_is_megakernel(scene):
    """render_progressive(backend="auto") is the megakernel's chunk sums."""
    from oclpathtracer_tpu.render.driver import render_progressive

    img = render_progressive(scene, CFG, total_spp=2, samples_per_step=1,
                             backend="auto")
    scan, table, emi, classes = prepare_scan(scene)
    a, _ = render_samples_pallas_stats(table, CFG, 0, 1, scan=scan,
                                       emi_const=emi, classes=classes)
    b, _ = render_samples_pallas_stats(table, CFG, 1, 1, scan=scan,
                                       emi_const=emi, classes=classes)
    np.testing.assert_array_equal(np.asarray(img),
                                  (np.asarray(a) + np.asarray(b)) / 2.0)
    with pytest.raises(ValueError, match="backend"):
        render_progressive(scene, CFG, total_spp=1, backend="wavefront")


# ---- adjoint kernel ----------------------------------------------------------------

def test_adjoint_forward_equals_tp_megakernel(scene):
    table, ct, C, _ = prepare_grad_scene(scene)
    img, g = render_grads_pallas(table, ct, CFG, 0, 2, C, with_grads=False)
    _, t2, emi, classes = prepare_scan(scene, "tp")
    ref, _ = render_samples_pallas_stats(t2, CFG, 0, 2, scan="tp",
                                         classes=classes)
    assert g is None
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))


def test_adjoint_matches_jnp_ad(scene):
    """Hand-derived class gradients ≡ reverse-mode AD through the parity twin
    at an interior parameter point (the clamp never binds there)."""
    table, ct, C, mat_class = prepare_grad_scene(scene)
    ct = chip_smoke.interior_class_table(ct)
    w = jnp.asarray(np.random.default_rng(0).normal(
        size=(CFG.n_pixels, 3)).astype(np.float32))
    _, g = render_grads_pallas(table, ct, CFG, 0, 2, C, weight=w)
    g_ad = chip_smoke.twin_class_grads(scene, CFG, ct, mat_class, w, 2)
    assert g.shape == (C, 6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), rtol=1e-4,
                               atol=1e-3)


# ---- chip_smoke phases at tiny size on the CPU ---------------------------------------

def test_chip_smoke_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_chip_smoke_image_comparison():
    a = np.ones((1000, 3), np.float32)
    b = a.copy()
    assert chip_smoke.images_agree(chip_smoke.compare_images(a, b))
    b[0] = 5.0  # one divergent pixel in 1000 moves the mean 0.4%: too much
    st = chip_smoke.compare_images(a, b)
    assert st["mismatch"] == 1e-3 and not chip_smoke.images_agree(st)


@pytest.mark.parametrize("phase,kw", [
    ("phase_render", dict(size=16, bounces=2, spp=2, full=False)),
    ("phase_cli", dict(size=16, bounces=2, spp=2, full=False)),
    ("phase_parity", dict(size=16, bounces=2, spp=1)),
    ("phase_adjoint", dict(size=16, bounces=2, spp=2)),
    ("phase_big_scene", dict(size=16, bounces=2, spp=1, n_spheres=2,
                             subdivisions=1)),
])
def test_chip_smoke_phase_tiny(phase, kw, tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    res = getattr(chip_smoke, phase)(**kw)
    assert res


# ---- on the card ---------------------------------------------------------------------

@pytest.mark.gpu
def test_route_compiles_for_gpu():
    p = route.pallas_params(4)
    assert p["backend"] == "triton" and "interpret" not in p


@pytest.mark.gpu
@pytest.mark.parametrize("scan", SCANS)
def test_compiled_megakernel_matches_parity(scan):
    res = chip_smoke.phase_parity(size=64, bounces=4, spp=2, scans=(scan,))
    assert chip_smoke.images_agree(res[scan])


@pytest.mark.gpu
def test_compiled_adjoint_matches_ad():
    res = chip_smoke.phase_adjoint(size=64, bounces=4, spp=2)
    assert res["max_rel_err"] <= chip_smoke.GRAD_REL
