"""Test configuration: run everything on a virtual 8-device CPU platform.

Multi-device logic is validated on a `--xla_force_host_platform_device_count=8` CPU
mesh (SURVEY.md §4 implication d). Tests marked `gpu` need the card and skip here;
`chip_smoke.py` runs them on the GPU, setting OCLPT_TESTS_ON_GPU=1 so that this
file leaves the platform alone."""

import os

ON_GPU = os.environ.get("OCLPT_TESTS_ON_GPU") == "1"
if not ON_GPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")
# Tests must NOT enable the persistent compilation cache via the default dir
# (the CLI does so as a side effect): thousands of interpret-mode entries are
# useless across sessions, sharing the user-level dir with concurrent/killed
# bench processes corrupts it, and long cache-write sessions have segfaulted
# inside jax's zstd writer (deterministically, ~70 tests in). "off" is the
# runtime.cache kill-switch; tests that exercise the cache itself pass an
# explicit tmp dir, which bypasses it.
os.environ["OCLPT_COMPILATION_CACHE"] = "off"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from oclpathtracer_tpu.scene import load_cornell_box


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled executables between test modules: with hundreds of
    interpret-mode kernel programs live at once, XLA's CPU compiler has
    segfaulted on the next big compile."""
    jax.clear_caches()
    yield


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked `gpu` run only where JAX's default backend is a GPU.
    Decided here, at run time — never at import, so every pytest-xdist worker
    collects the same tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU; chip_smoke.py runs the tests marked gpu "
                    "on the card")
    yield


@pytest.fixture(scope="session")
def scene():
    return load_cornell_box()


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices("cpu")
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs
