"""Device discovery and queries.

JAX equivalent of the reference's device bring-up stack (SURVEY.md §3.1):
clewInit → DeviceCL::initialize → platform/device enumeration → context + queue
(clew.cpp:165-210, AdlCL.cpp:68-271). PJRT does all of that inside `jax.devices()`;
this module exposes the same *queries* the reference offers (name, vendor, memory
totals/usage — Adl.h:139-194, AdlCL.cpp:385-483) plus mesh construction helpers for
the multi-device path the reference never had.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """Device queries ≡ Device::getDeviceName/getDeviceVendor/... (Adl.h:161-170)."""

    index: int
    platform: str
    kind: str
    memory_total: Optional[int]       # bytes, if the backend reports it
    memory_in_use: Optional[int]      # bytes, if the backend reports it


def get_devices(backend: Optional[str] = None) -> list:
    """All addressable devices (≡ DeviceUtils::getNDevices, Adl.cpp:83-104 — except
    ours returns the real count; the reference's contains a dead-switch stub and
    always reports 1, Adl.cpp:86)."""
    return jax.devices(backend) if backend else jax.devices()


def memory_stats(device) -> dict:
    """Live memory accounting (≡ Device::getUsedMemory/Peak, Adl.h:168-170).

    Returns {} when the backend doesn't expose stats (CPU)."""
    try:
        return device.memory_stats() or {}
    except Exception:
        return {}


def device_info(device=None) -> DeviceInfo:
    d = device or jax.devices()[0]
    stats = memory_stats(d)
    return DeviceInfo(
        index=d.id,
        platform=d.platform,
        kind=getattr(d, "device_kind", "unknown"),
        memory_total=stats.get("bytes_limit"),
        memory_in_use=stats.get("bytes_in_use"),
    )


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a device mesh, e.g. make_mesh((8,), ('tiles',)).

    The single entry point the parallel layer uses; tests pass the 8-device virtual
    CPU platform, production passes the GPUs of a host.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    total = int(np.prod(axis_sizes))
    if devs.size < total:
        raise ValueError(f"need {total} devices for mesh {tuple(axis_sizes)}, have {devs.size}")
    return Mesh(devs[:total].reshape(axis_sizes), axis_names)
