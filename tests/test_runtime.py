"""Runtime-layer tests: buffer capability mapping, launch replay, errors, metrics,
device queries, compilation cache."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from oclpathtracer_tpu.runtime import buffers, replay
from oclpathtracer_tpu.runtime.cache import enable_compilation_cache
from oclpathtracer_tpu.runtime.devices import device_info, get_devices, make_mesh
from oclpathtracer_tpu.runtime.profiling import Stopwatch, timed
from oclpathtracer_tpu.utils.errors import ErrorCode, PathTracerError, require
from oclpathtracer_tpu.utils.metrics import RenderMetrics


def test_buffer_roundtrip():
    b = buffers.allocate((16, 3))
    host = np.arange(48, dtype=np.float32).reshape(16, 3)
    b = buffers.write(b, host)
    np.testing.assert_array_equal(buffers.read(b), host)
    np.testing.assert_array_equal(buffers.read(buffers.clear(b)), 0)
    np.testing.assert_array_equal(buffers.read(buffers.fill(b, 7.0)), 7.0)


def test_buffer_grow_preserves_contents():
    b = buffers.write(buffers.allocate((4,)), np.array([1, 2, 3, 4], np.float32))
    g = buffers.grow(b, 8)
    np.testing.assert_array_equal(buffers.read(g), [1, 2, 3, 4, 0, 0, 0, 0])
    s = buffers.grow(b, 2)
    np.testing.assert_array_equal(buffers.read(s), [1, 2])


def test_launch_replay(tmp_path):
    """≡ Launcher::serializeToFile/deserializeFromFile round trip."""
    fn = jax.jit(lambda a, b: a * 2.0 + b)
    args = (jnp.arange(8, dtype=jnp.float32), jnp.ones((8,), jnp.float32))
    want = np.asarray(fn(*args))

    p = str(tmp_path / "launch")
    replay.save_launch(p, args, meta={"what": "test"})
    got = np.asarray(replay.replay(fn, p, args))
    np.testing.assert_array_equal(got, want)


def test_errors():
    require(True)
    with pytest.raises(PathTracerError) as e:
        require(False, ErrorCode.ERROR_INVALID_VALUE, "bad arg")
    assert e.value.code == ErrorCode.ERROR_INVALID_VALUE


def test_metrics_accounting():
    m = RenderMetrics(n_pixels=100).start()
    m.step(samples=0, first_call=True)
    m.step(samples=4, segments=1e6)
    s = m.summary()
    assert s["samples"] == 4
    assert s["mrays_per_s"] >= 0.0
    assert m.compile_s >= 0.0


def test_device_queries(cpu_devices):
    devs = get_devices()
    assert len(devs) >= 1
    info = device_info(devs[0])
    assert info.platform == "cpu"
    mesh = make_mesh((8,), ("tiles",), cpu_devices)
    assert mesh.shape["tiles"] == 8
    with pytest.raises(ValueError):
        make_mesh((16,), ("tiles",), cpu_devices)


@pytest.fixture
def _restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compilation_cache_dir(tmp_path, monkeypatch, _restore_cache_config):
    """An explicit directory always wins, whatever the environment says."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    d = enable_compilation_cache(str(tmp_path / "xla"))
    assert d == str(tmp_path / "xla") and os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d


def _config_updates(monkeypatch):
    from oclpathtracer_tpu.runtime import cache

    calls = {}
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return cache, calls


def test_cache_dir_from_environment(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; no dir is set in
    code (only the size/time thresholds)."""
    cache, calls = _config_updates(monkeypatch)
    monkeypatch.delenv("OCLPT_COMPILATION_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cache.default_cache_dir() == str(tmp_path / "env")
    assert cache.enable_compilation_cache() == str(tmp_path / "env")
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    """Unset: one fixed directory at the checkout root, listed in .gitignore."""
    cache, calls = _config_updates(monkeypatch)
    monkeypatch.delenv("OCLPT_COMPILATION_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache.os, "makedirs", lambda *a, **k: None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.default_cache_dir() == os.path.join(root, ".jax_cache")
    assert cache.enable_compilation_cache() == os.path.join(root, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == os.path.join(root,
                                                              ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_off_switch(monkeypatch):
    cache, calls = _config_updates(monkeypatch)
    monkeypatch.setenv("OCLPT_COMPILATION_CACHE", "off")
    assert cache.enable_compilation_cache() == ""
    assert calls == {}


def test_stopwatch_and_timed():
    sw = Stopwatch().start()
    _ = sw.split()
    assert sw.elapsed_ms() >= 0
    out, secs = timed(jax.jit(lambda x: x + 1), jnp.zeros((4,)))
    assert secs >= 0 and np.asarray(out).shape == (4,)


def test_compile_listener_fires():
    """register_compile_listener sees a backend compile for a fresh program."""
    from oclpathtracer_tpu.runtime.cache import register_compile_listener

    events = []
    register_compile_listener(lambda ev, s: events.append((ev, s)))

    @jax.jit
    def fresh(x):
        return x * 3.0 + jnp.sin(x)

    fresh(jnp.arange(7.0)).block_until_ready()
    assert events, "no compile event observed"
    assert all(s >= 0.0 for _, s in events)
