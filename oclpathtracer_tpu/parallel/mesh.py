"""Mesh construction and canonical shardings.

One axis, 'tiles': pixels/rays are embarrassingly parallel, so a 1-D layout wastes
nothing; the only collectives are the gradient psum and debug all_gathers, which
XLA hands to NCCL over NVLink between the cards of a host. Multi-host extends the
same axis across processes without code changes (SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"


def default_mesh(devices: Optional[Sequence] = None, n: Optional[int] = None) -> Mesh:
    """1-D mesh over all (or the first n) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if n is not None:
        devs = devs[:n]
    return Mesh(np.asarray(devs), (TILE_AXIS,))


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (pixel/ray) axis over 'tiles'."""
    return NamedSharding(mesh, P(TILE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
