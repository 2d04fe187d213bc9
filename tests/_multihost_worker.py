"""Worker process for tests/test_parallel.py::test_multihost_two_process.

Runs as `python _multihost_worker.py <rank> <nproc> <port> <outdir>`: brings up
the REAL jax.distributed runtime (SURVEY.md §4 implication d — multi-process CPU
simulation so N-host logic runs without a cluster), renders this host's pixel strip
through the documented multihost workflow, runs one genuine cross-process
collective, and writes artifacts for the parent test to verify.
"""

import os
import sys

rank, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])

# Each process hosts 2 virtual CPU devices → a 2-process, 4-device cluster.
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["OCLPT_COMPILATION_CACHE"] = "off"

import jax
import jax.numpy as jnp
import numpy as np

from oclpathtracer_tpu.parallel import multihost

multihost.initialize(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=rank)
assert multihost.process_count() == nproc, multihost.process_count()
assert multihost.is_coordinator() == (rank == 0)
assert len(jax.devices()) == 2 * nproc, jax.devices()

from oclpathtracer_tpu import RenderConfig
from oclpathtracer_tpu.core import rng
from oclpathtracer_tpu.diff.inverse import render_spp
from oclpathtracer_tpu.scene import load_cornell_box

scene = load_cornell_box()
cfg = RenderConfig(width=32, height=16, bounces=2)

# The multi-host branch of host_local_pixel_slice: this process's contiguous
# strip of the global pixel space (512 px / 4 devices → 256 px per process).
sl = multihost.host_local_pixel_slice(cfg.n_pixels)
assert sl.stop - sl.start == cfg.n_pixels // nproc, sl
pixel_ids = jnp.arange(sl.start, sl.stop, dtype=jnp.int32)

# Absolute-pixel-id keying ⇒ each host's strip is bitwise what the 1-host
# render produces for those rows (no communication in the forward pass).
img = render_spp(scene, cfg, 2, rng.make_key(5), pixel_ids=pixel_ids)
np.save(os.path.join(outdir, f"strip_{rank}.npy"), np.asarray(img))

# One REAL cross-process collective over the global mesh: psum of the strip
# sums via shard_map on a device-sharded global array.
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = multihost.global_mesh()
assert mesh.shape["tiles"] == 2 * nproc
local_per_dev = np.asarray(img).reshape(2, -1, 3)  # this host's 2 device shards
garr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("tiles")), local_per_dev,
    (2 * nproc,) + local_per_dev.shape[1:])
total = jax.jit(jax.shard_map(
    lambda x: jax.lax.psum(jnp.sum(x), "tiles"),
    mesh=mesh, in_specs=P("tiles"), out_specs=P()))(garr)
np.save(os.path.join(outdir, f"psum_{rank}.npy"), np.asarray(total))
print(f"worker {rank}: ok, psum={float(total):.6f}")
