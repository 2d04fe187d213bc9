"""Buffer capabilities — the Adl Buffer<T>/BufferUtils surface, on jax.Array.

The reference's typed device buffer (Buffer<T>, Adl.h:200-265 / Adl.inl:130-491)
exposes: allocate, write/read (H2D/D2H/D2D), clear/fill, map/unmap (getHostPtr),
grow (setSize), and cross-backend migration (BufferUtils::map, Adl.inl:304-469).
`jax.Array` subsumes all of it; this module states the mapping executable-ly — each
helper is the one-line JAX equivalent, kept as API so the capability row is
testable (tests/test_runtime.py) and discoverable by reference users.

In-place reuse (the reference's raison d'être for buffers) maps to donation:
jit(..., donate_argnums=...) — see render/driver.py's accumulator.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np


def allocate(shape, dtype=jnp.float32, device=None) -> jax.Array:
    """≡ Buffer<T>::allocate (Adl.inl:142-165): zero-initialized device memory.

    (The reference's alloc leaves memory uninitialized; XLA buffers are always
    defined — zeros is the closest honest equivalent.)"""
    x = jnp.zeros(shape, dtype)
    return jax.device_put(x, device) if device is not None else x


def write(buf: jax.Array, host: np.ndarray) -> jax.Array:
    """≡ Buffer<T>::write H2D (Adl.inl:204-218) — functional: returns the new buffer."""
    arr = jnp.asarray(host, buf.dtype).reshape(buf.shape)
    return jax.device_put(arr, buf.sharding)


def read(buf: jax.Array) -> np.ndarray:
    """≡ Buffer<T>::read D2H + waitForCompletion (Adl.inl:220-233)."""
    return np.asarray(jax.device_get(buf))


def clear(buf: jax.Array) -> jax.Array:
    """≡ Buffer<T>::clear — the reference compiles a tiny _memclear kernel on the
    fly (AdlCL.inl:341-384); XLA fuses a broadcast-zero for free."""
    return jnp.zeros_like(buf)


def fill(buf: jax.Array, value) -> jax.Array:
    """≡ Buffer<T>::fill via embedded _memfill kernels (AdlCL.inl:386-431)."""
    return jnp.full_like(buf, value)


def map_host(buf: jax.Array) -> np.ndarray:
    """≡ BufferUtils::mapInplace / getHostPtr (Adl.h:267-291): a host view.

    JAX arrays are immutable — mutation goes through .at[] / donation instead of
    writing through the mapped pointer."""
    return np.asarray(buf)


def migrate(buf: jax.Array, device_or_sharding) -> jax.Array:
    """≡ BufferUtils::map<TYPE, COPY> cross-backend migration (Adl.inl:304-351).

    The reference stages device→device copies through a host temp (Adl.inl:338-346);
    jax.device_put lets XLA pick the direct path (NVLink between cards)."""
    return jax.device_put(buf, device_or_sharding)


def grow(buf: jax.Array, new_len: int) -> jax.Array:
    """≡ Buffer<T>::setSize grow-realloc preserving contents (Adl.inl:261-287)."""
    if new_len <= buf.shape[0]:
        return buf[:new_len]
    pad = [(0, new_len - buf.shape[0])] + [(0, 0)] * (buf.ndim - 1)
    return jnp.pad(buf, pad)


def live_buffer_count(backend: Optional[str] = None) -> int:
    """≡ the reference's leak accounting (m_memoryUsage assert at teardown,
    Adl.cpp:204): count of live device arrays, usable in tests."""
    arrays = jax.live_arrays(backend) if backend else jax.live_arrays()
    return sum(1 for _ in arrays)
