"""Multi-host runtime — jax.distributed bring-up and host-spanning meshes.

The reference has no distributed story at all (SURVEY.md §2.3). Across processes
the runtime work is done by `jax.distributed.initialize()` + XLA collectives; this
module wraps bring-up with the framework's conventions:

  * one GLOBAL 1-D 'tiles' axis across every card of every process (NVLink
    between the cards of a host; the only collective in training is the small
    parameter-gradient psum, so cross-host traffic is parameters, never rays);
  * each host feeds only its addressable shard of the pixel space
    (host_local_pixel_slice below) — no host ever materializes the full image
    except for explicit debug gathers;
  * sample streams key on absolute pixel ids (core/rng.py), so the N-host render
    is bitwise identical to the 1-host render — verified on the virtual CPU mesh
    by tests/test_parallel.py, which is exactly the simulation SURVEY.md §4
    prescribes for multi-node logic without a cluster.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from oclpathtracer_tpu.parallel.mesh import TILE_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the multi-host runtime (no-op for single-process).

    Pass the arguments explicitly (coordinator 'host:port', world size, rank):
    nothing on a plain GPU host tells JAX of a cluster.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def global_mesh() -> Mesh:
    """1-D 'tiles' mesh over every device in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (TILE_AXIS,))


def host_local_pixel_slice(n_pixels: int) -> slice:
    """The contiguous pixel range this process feeds.

    Pixels shard evenly over the global device ORDER (the same jax.devices()
    order global_mesh uses); a host owns the union of its addressable
    devices' shards, which is contiguous under the 1-D layout. Positions in
    the device tuple — NOT d.id values — define the order: multi-process JAX
    strides raw device ids per process (e.g. rank 1's CPU devices are ids
    2048, 2049), so ids are neither dense nor usable as shard indices.

    Non-divisible pixel counts pad-and-mask: each device
    owns ceil(n/n_dev) padded rows (matching parallel.sharded.shard_pixels),
    and the returned slice is clipped to the REAL pixel range — a trailing
    host may own fewer (or zero) real pixels, never an error.
    """
    devs = jax.devices()
    n_dev = len(devs)
    per_dev = (n_pixels + n_dev - 1) // n_dev  # padded rows per device
    me = jax.process_index()
    pos = [i for i, d in enumerate(devs) if d.process_index == me]
    lo, hi = pos[0], pos[-1]
    if pos != list(range(lo, hi + 1)):
        raise ValueError("host's devices are not contiguous in the global order")
    return slice(min(lo * per_dev, n_pixels), min((hi + 1) * per_dev, n_pixels))


def process_count() -> int:
    return jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
