"""Persistent XLA compilation cache.

The reference hand-rolls an on-disk kernel binary cache: filename keyed by source
file + option hash + device + driver version, mtime freshness, checksum sidecars
(KernelBuilderCLImpl, AdlKernelUtilsCL.cpp:130-237). XLA ships the same capability;
enabling it is one config call. Keying by device/compiler fingerprint, integrity
checking, and invalidation are handled inside XLA.

Where the cache lives:
  * `JAX_COMPILATION_CACHE_DIR` set → JAX reads it itself and this module sets
    no directory in code;
  * unset → `.jax_cache/` at the root of the checkout (git-ignored). A fixed
    path matters: the path is part of the cache key, so a moving dir never hits.
`OCLPT_COMPILATION_CACHE=off` turns the default enablement off (the test suite).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")
_OFF = ("off", "0", "none")


def default_cache_dir() -> str:
    """The directory enable_compilation_cache() uses when given none."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Enable the persistent compilation cache (idempotent). Returns the dir used,
    or "" when switched off.

    Kill-switch: OCLPT_COMPILATION_CACHE=off (or "0"/"none") makes default-dir
    enablement a no-op — used by the test suite, where thousands of tiny
    interpret-mode kernel entries are useless. An EXPLICIT cache_dir argument
    always wins (the cache's own unit tests exercise the real thing)."""
    if cache_dir is None:
        if os.environ.get("OCLPT_COMPILATION_CACHE", "").lower() in _OFF:
            return ""
        cache_dir = default_cache_dir()
    if cache_dir != os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program regardless of compile time; the render-step module is the
    # thing we most want cached and heuristics can skip "small" programs.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def log_compiles(enable: bool = True) -> None:
    """Log every XLA compilation (jit cache miss) — the observability half of the
    reference's compile bracket (compile start/end logged at
    AdlKernelUtilsCL.cpp:254-264 via its CompileCallback)."""
    jax.config.update("jax_log_compiles", enable)


def register_compile_listener(callback) -> None:
    """≡ the reference's pluggable CompileCallback (Adl.h:23-30, fired around
    clBuildProgram at AdlKernelUtilsCL.cpp:254-264,353-354): `callback(event,
    seconds)` is invoked when the runtime finishes compiling a program, with the
    backend compile duration. Registration is process-wide and permanent (JAX
    exposes no deregistration), matching the reference's static callback slot."""
    from jax import monitoring

    def _listener(event: str, duration: float, **kw) -> None:
        if "compile" in event:
            callback(event, duration)

    monitoring.register_event_duration_secs_listener(_listener)
