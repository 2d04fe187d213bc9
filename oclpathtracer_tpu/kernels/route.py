"""The one place that decides how a Pallas kernel runs on this platform.

  gpu  → compiled through Triton (`backend="triton"`), with the kernel's warp
         count in Triton's compiler parameters;
  cpu  → the Pallas interpreter, for tests only;
  else → an error: there is no route, and nothing silently falls back.

Every `pallas_call` in `kernels/` takes its keyword arguments from
`pallas_params`, so no kernel can drop into interpret mode on the card.
"""

from __future__ import annotations

import jax
from jax.experimental.pallas import triton as pltriton

BACKEND = "triton"


def _platform() -> str:
    return jax.default_backend()


def pallas_params(num_warps: int) -> dict:
    """Keyword arguments for `pl.pallas_call` on the current platform."""
    platform = _platform()
    if platform == "gpu":
        return dict(backend=BACKEND,
                    compiler_params=pltriton.CompilerParams(num_warps=num_warps))
    if platform == "cpu":
        return dict(backend=BACKEND, interpret=True)
    raise RuntimeError(f"no Pallas route for platform {platform!r}: the "
                       "kernels compile for the GPU and interpret on the CPU")
