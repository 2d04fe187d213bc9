"""Sharding tests on the 8-device virtual CPU mesh (SURVEY.md §4 implication d).

The north-star invariant: sharded rendering is BITWISE identical to single-device
rendering, for any device count, because sample streams key on absolute pixel ids.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.parallel.mesh import default_mesh
from oclpathtracer_tpu.parallel.sharded import render_progressive_sharded, shard_pixels
from oclpathtracer_tpu.render.driver import render_progressive

pytestmark = pytest.mark.slow  # shard_map + Pallas interpret + subprocess pods

CFG = RenderConfig(width=32, height=32, bounces=4)


def test_shard_pixels_pads_and_masks(cpu_devices):
    mesh = default_mesh(cpu_devices)
    ids = shard_pixels(CFG, mesh)
    assert ids.shape == (CFG.n_pixels,)  # divisible → no pad
    # Non-divisible images round up to a multiple of the mesh and clamp the
    # tail to the last real pixel (pad-and-mask).
    bad = RenderConfig(width=33, height=7)  # 231 px on 8 devices → 232
    ids = np.asarray(shard_pixels(bad, mesh))
    assert ids.shape == (232,)
    assert (ids[:231] == np.arange(231)).all() and ids[231] == 230


def test_sharded_render_non_divisible_bitwise(scene, cpu_devices):
    """A 33×9 image (297 px, not divisible by 8) renders bitwise-identically
    to the single-device path — the pad tail is dropped at assembly."""
    cfg = RenderConfig(width=33, height=9, bounces=2)
    mesh = default_mesh(cpu_devices, n=8)
    img_sharded = render_progressive_sharded(scene, cfg, mesh, total_spp=2,
                                             samples_per_step=2)
    img_single = render_progressive(scene, cfg, total_spp=2, samples_per_step=2)
    assert img_sharded.shape == (cfg.n_pixels, 3)
    assert np.array_equal(np.asarray(img_sharded), np.asarray(img_single))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device_bitwise(scene, cpu_devices, n_dev):
    mesh = default_mesh(cpu_devices, n=n_dev)
    img_sharded = render_progressive_sharded(scene, CFG, mesh, total_spp=4,
                                             samples_per_step=2)
    img_single = render_progressive(scene, CFG, total_spp=4, samples_per_step=2)
    assert np.array_equal(np.asarray(img_sharded), np.asarray(img_single)), (
        "sharded render must be bitwise identical to single-device"
    )


def test_sharded_layouts_agree(scene, cpu_devices):
    """2-way and 8-way meshes must also agree with each other bitwise."""
    img2 = render_progressive_sharded(scene, CFG, default_mesh(cpu_devices, n=2),
                                      total_spp=2, samples_per_step=2)
    img8 = render_progressive_sharded(scene, CFG, default_mesh(cpu_devices, n=8),
                                      total_spp=2, samples_per_step=2)
    assert np.array_equal(np.asarray(img2), np.asarray(img8))


def test_graft_entry_single_chip():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out = np.asarray(out)
    assert out.shape == (64 * 64, 3)
    assert np.isfinite(out).all() and out.min() >= 0.0


def test_graft_entry_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@pytest.mark.parametrize("scan_req", ["parity", "fast", "tp"])
def test_sharded_megakernel_bitwise_matches_single(scene, cpu_devices, scan_req):
    """The Pallas kernel under shard_map (absolute pid_base per device) must be
    bitwise identical to the single-device kernel — for every scan, including
    the production tp scan that `auto` resolves to on the canonical scene."""
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan,
        render_samples_pallas,
    )
    from oclpathtracer_tpu.parallel.sharded_pallas import render_pallas_sharded

    cfg = RenderConfig(width=64, height=32, bounces=4)  # 2048 px / 8 dev = 256
    mesh = default_mesh(cpu_devices)
    scan, table, emi, classes = prepare_scan(scene, scan_req)
    img_sh = render_pallas_sharded(scene, cfg, mesh, total_spp=2, scan=scan_req)
    img_1 = render_samples_pallas(table, cfg, 0, 2, scan=scan, emi_const=emi,
                                  classes=classes) / 2
    np.testing.assert_array_equal(np.asarray(img_sh), np.asarray(img_1))


def test_multihost_two_process(scene, tmp_path):
    """REAL jax.distributed bring-up: 2 processes × 2 CPU devices (SURVEY §4d).

    Each worker initializes the distributed runtime against a local
    coordinator, renders its host_local_pixel_slice strip, and psums over the
    global 4-device mesh. The assembled strips must be bitwise identical to
    the single-process render, and both workers must agree on the psum."""
    import socket
    import subprocess
    import sys as _sys
    from pathlib import Path

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo = str(Path(__file__).resolve().parents[1])
    worker = str(Path(__file__).with_name("_multihost_worker.py"))
    # Sanitized env: no inherited XLA flags or ambient JAX settings — the
    # workers are a pure 2-process CPU cluster.
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith(("XLA_", "JAX_", "PALLAS_"))
                   or k == "PYTHONPATH")}
    env["PYTHONPATH"] = repo
    procs = [
        subprocess.Popen([_sys.executable, worker, str(r), "2", str(port),
                          str(tmp_path)], env=env, cwd=repo,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    img = np.concatenate([np.load(tmp_path / f"strip_{r}.npy") for r in range(2)])
    cfg = RenderConfig(width=32, height=16, bounces=2)
    from oclpathtracer_tpu.diff.inverse import render_spp

    ref = np.asarray(render_spp(scene, cfg, 2, rng.make_key(5)))
    np.testing.assert_array_equal(img, ref)

    psums = [float(np.load(tmp_path / f"psum_{r}.npy")) for r in range(2)]
    assert psums[0] == psums[1]
    np.testing.assert_allclose(psums[0], img.sum(), rtol=1e-5)


def test_multihost_helpers_single_process(cpu_devices):
    from oclpathtracer_tpu.parallel import multihost

    mesh = multihost.global_mesh()
    assert mesh.shape["tiles"] == len(jax.devices())
    s = multihost.host_local_pixel_slice(1024)
    assert (s.start, s.stop) == (0, 1024)  # single process owns everything
    s = multihost.host_local_pixel_slice(1001)  # non-divisible: clipped pad
    assert (s.start, s.stop) == (0, 1001)
    assert multihost.process_count() == 1
    assert multihost.is_coordinator()
