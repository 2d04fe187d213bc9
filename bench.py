"""Benchmark: traced segments per second, Cornell box at 512², on one GPU.

Prints ONE JSON line per bounce depth (4, and the reference's cap of 16) for
the auto route — render_progressive(backend="auto"), i.e. the fused megakernel
with the fastest scan the scene supports. A traced segment is a lane alive at
a bounce, counted by the kernel itself. Every line names the device and the
card's power limit; compile time is reported as set-up time. Without a GPU it
refuses to run.

Workload: the reference's canonical scene and resolution (512x512,
cornellbox.bin, 36 tris — RaytraceTest.cpp:219), progressive 1-spp frames with
the REFERENCE's RNG streams.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import numpy as np

WIDTH = HEIGHT = 512
DEPTHS = (4, 16)    # 16 = the reference's BOUNCES cap (GenerateColors.cl:5)
SPP = 32            # samples per timed call
REPS = 5


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform}); refusing to run",
              file=sys.stderr)
        return 1

    from chip_smoke import card_line
    from oclpathtracer_tpu import RenderConfig
    from oclpathtracer_tpu.kernels.megakernel import (
        prepare_scan, render_samples_pallas_stats)
    from oclpathtracer_tpu.runtime import enable_compilation_cache
    from oclpathtracer_tpu.scene import load_cornell_box

    enable_compilation_cache()
    scene = load_cornell_box()
    scan, table, emi, classes = prepare_scan(scene, "auto")
    card = card_line()
    for bounces in DEPTHS:
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, bounces=bounces)

        def run():
            return render_samples_pallas_stats(table, cfg, 0, SPP, scan=scan,
                                               emi_const=emi, classes=classes)

        t0 = time.perf_counter()
        img, segs = jax.block_until_ready(run())
        setup_s = time.perf_counter() - t0
        assert np.isfinite(np.asarray(img)).all(), "non-finite image"
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(json.dumps({
            "metric": f"cornell_{WIDTH}_{bounces}bounce_path_trace",
            "value": float(segs) / best / 1e6,
            "unit": "Msegments/s",
            "ms_per_spp": 1e3 * best / SPP,
            "setup_s": setup_s,
            "scan": scan,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
