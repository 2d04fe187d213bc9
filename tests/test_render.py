"""Render-driver tests: accumulation, checkpoint/resume, image I/O, export quirks."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from oclpathtracer_tpu.config import RenderConfig
from oclpathtracer_tpu.render.accumulate import (
    Accumulator,
    gamma22_to_linear,
    linear_to_srgb_gamma22,
    reference_average,
)
from oclpathtracer_tpu.render import checkpoint as ckpt
from oclpathtracer_tpu.render.driver import render_progressive
from oclpathtracer_tpu.render.image import read_ppm, to_u8, write_png, write_ppm

CFG = RenderConfig(width=16, height=16, bounces=4, samples_per_batch=4)


def test_accumulator_mean():
    acc = Accumulator.zeros(8)
    acc = acc.add(jnp.full((8, 3), 2.0))
    acc = acc.add(jnp.full((8, 3), 4.0))
    assert np.allclose(np.asarray(acc.mean()), 3.0)
    assert int(acc.count) == 2


def test_reference_average_discards_frame0():
    """The reference recurrence multiplies frame 0 by (1-1)=0 at frame 1
    (GenerateColors.cl:320) — the stored average is over frames 1..S-1."""
    rs = np.random.RandomState(0)
    frames = jnp.asarray(rs.uniform(0.1, 1.0, (5, 7, 3)).astype(np.float32))
    fb = np.asarray(reference_average(frames))
    want = linear_to_srgb_gamma22(jnp.mean(frames[1:], axis=0))
    assert np.allclose(fb, np.asarray(want), atol=2e-3)


def test_gamma_roundtrip():
    x = jnp.asarray(np.random.RandomState(1).uniform(0, 2, (32, 3)).astype(np.float32))
    y = gamma22_to_linear(linear_to_srgb_gamma22(x))
    assert np.allclose(np.asarray(y), np.asarray(x), atol=1e-3)


def test_progressive_matches_manual_mean(scene):
    from oclpathtracer_tpu.core import rng as _rng
    from oclpathtracer_tpu.integrators.path import render_sample

    img = render_progressive(scene, CFG, total_spp=8, seed=0)
    key = _rng.make_key(0)
    acc = np.zeros((CFG.n_pixels, 3), np.float32)
    for s in range(8):
        acc += np.asarray(render_sample(scene, CFG, jnp.int32(s), key)[0])
    np.testing.assert_allclose(np.asarray(img), acc / 8, rtol=1e-5, atol=1e-6)


def test_checkpoint_resume_is_exact(scene, tmp_path):
    path = str(tmp_path / "ck.npz")
    full = render_progressive(scene, CFG, total_spp=8, seed=0)

    # Render 4, "crash", resume to 8 from the checkpoint.
    render_progressive(scene, CFG, total_spp=4, seed=0, checkpoint_path=path)
    resumed = render_progressive(scene, CFG, total_spp=8, seed=0, checkpoint_path=path)
    np.testing.assert_allclose(np.asarray(resumed), np.asarray(full), rtol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "acc.npz")
    acc = Accumulator(sum=jnp.ones((4, 3)) * 5, count=jnp.int32(5))
    ckpt.save(path, acc, 5)
    loaded = ckpt.load(path)
    assert loaded is not None
    acc2, nxt = loaded
    assert nxt == 5
    np.testing.assert_array_equal(np.asarray(acc2.sum), np.asarray(acc.sum))
    assert ckpt.load(str(tmp_path / "missing.npz")) is None


def test_to_u8_clamps_like_reference():
    # f2c: min((int)(a*255), 255) — RaytraceTest.cpp:78-83.
    vals = np.asarray(to_u8(np.array([0.0, 0.5, 1.0, 2.0, -1.0])))
    assert list(vals) == [0, 127, 255, 255, 0]


def test_ppm_roundtrip(tmp_path):
    img = np.random.RandomState(2).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    path = str(tmp_path / "t.ppm")
    write_ppm(path, img, 8, 8, gamma=1.0)
    back = read_ppm(path)
    assert back.shape == (8, 8, 3)
    np.testing.assert_array_equal(back, to_u8(img))


def test_ppm_reference_quirk_double_gamma(tmp_path):
    img = np.full((4, 4, 3), 0.25, np.float32)
    path = str(tmp_path / "q.ppm")
    write_ppm(path, img, 4, 4, reference_quirk=True)
    back = read_ppm(path)
    want = to_u8(np.sqrt(np.power(0.25, 1 / 2.2)) * np.ones((4, 4, 3)))
    np.testing.assert_array_equal(back, want)


def test_png_writes_valid_header(tmp_path):
    img = np.random.RandomState(3).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    path = str(tmp_path / "t.png")
    write_png(path, img, 8, 8)
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data


@pytest.mark.slow  # interpret-mode kernel render dominates wall-time
def test_kernel_backend_matches_megakernel_direct(scene):
    """render_progressive(backend="auto") ≡ the raw kernel's chunk sums,
    bitwise per scan mode."""
    from oclpathtracer_tpu.kernels.megakernel import (
        pack_scene, render_samples_pallas_stats, scene_emissive_const)

    table = pack_scene(scene)
    emi = scene_emissive_const(scene)
    for scan, kw in (("parity", {}), ("fast", {"emi_const": emi})):
        img = render_progressive(scene, CFG, total_spp=4, backend="auto",
                                 samples_per_step=2, scan=scan)
        a, _ = render_samples_pallas_stats(table, CFG, 0, 2, scan=scan, **kw)
        b, _ = render_samples_pallas_stats(table, CFG, 2, 2, scan=scan, **kw)
        np.testing.assert_array_equal(np.asarray(img),
                                      (np.asarray(a) + np.asarray(b)) / 4.0)


@pytest.mark.slow  # interpret-mode kernel render dominates wall-time
def test_kernel_backend_checkpoint_resume(scene, tmp_path):
    path = str(tmp_path / "kacc.npz")
    full = render_progressive(scene, CFG, total_spp=4, backend="auto",
                              samples_per_step=2)
    render_progressive(scene, CFG, total_spp=2, backend="auto",
                       samples_per_step=2, checkpoint_path=path)
    resumed = render_progressive(scene, CFG, total_spp=4, backend="auto",
                                 samples_per_step=2, checkpoint_path=path)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(resumed))
