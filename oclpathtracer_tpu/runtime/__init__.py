"""Runtime layer — device discovery, compilation cache, profiling, native bindings.

This package is the JAX-side answer to the reference's Adl layers 0-3
(/root/reference/Adl: clew loader, DeviceCL, Buffer<T>, KernelManager/KernelBuilder,
Launcher — SURVEY.md §1). JAX/XLA/PJRT already provide device bring-up, typed device
arrays, kernel compilation + caching, and launch; this layer wraps those facilities
behind the same *capabilities* the reference exposes:

  devices.py   device enumeration / selection / memory stats  (≡ DeviceUtils, Adl.cpp:83-232)
  cache.py     persistent XLA compilation cache               (≡ KernelBuilder's on-disk
               binary cache, AdlKernelUtilsCL.cpp:130-237)
  profiling.py launch timing + device traces                  (≡ Device::toggleProfiling +
               getExecutionTimeNanoseconds, AdlCL.cpp:508-517)
  native.py    ctypes bindings to the C++ runtime components  (scene I/O, image I/O)
"""

from oclpathtracer_tpu.runtime.cache import enable_compilation_cache
from oclpathtracer_tpu.runtime.devices import (
    DeviceInfo,
    device_info,
    get_devices,
    memory_stats,
)
from oclpathtracer_tpu.runtime.profiling import Stopwatch, timed

__all__ = [
    "enable_compilation_cache",
    "DeviceInfo",
    "device_info",
    "get_devices",
    "memory_stats",
    "Stopwatch",
    "timed",
]
