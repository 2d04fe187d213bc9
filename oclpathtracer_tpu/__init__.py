"""oclpathtracer_tpu — a differentiable path tracer built on JAX/XLA/Pallas.

A from-scratch framework with the capabilities of the reference OpenCL path tracer
(PixelClear/OclPathTracer): scene I/O, camera ray generation, triangle intersection,
ambient occlusion, direct + indirect radiance integration with GGX specular bounces —
plus end-to-end differentiability and multi-device sharding that the reference lacks.

Layer map (see SURVEY.md §7 for the design rationale):

  scene/        scene binary I/O + SoA geometry pytrees
  core/         rays, RNG, camera, intersection, BRDF math (pure jnp, vmap/batch)
  integrators/  primary / AO / direct-NEE / full path trace (megakernel jnp form)
  kernels/      Pallas kernels, compiled through Triton on the GPU (fused
                path-trace megakernel, adjoint megakernel) and the route picker
  diff/         differentiable rendering: losses, gradient helpers
  parallel/     device mesh, shard_map tile/sample sharding, psum train steps
  render/       progressive render driver, accumulation, checkpoints, image I/O
  runtime/      device discovery, profiling, compilation-cache, native bindings
  native/       C++ runtime components (scene loader, image I/O, stopwatch)

The reference's Adl layers 0-3 (OpenCL loader, device runtime, buffers, kernel cache,
launcher — /root/reference/Adl/*) are provided by JAX/XLA/PJRT; `runtime/` documents
and wraps that mapping rather than reimplementing a device abstraction.
"""

__version__ = "0.1.0"

from oclpathtracer_tpu.config import RenderConfig, CameraConfig

__all__ = ["RenderConfig", "CameraConfig", "__version__"]
