"""Command-line harness — `python -m oclpathtracer_tpu <command>`.

The reference's CLI surface is main.cpp:154-177 (backend arg + gtest runner whose
real outputs are a device-info dump and the RayCast render → PPM). Equivalent
commands here, plus what this build adds (integrator ladder, bench):

  info                 device enumeration + queries (≡ DeviceTest.deviceInfo)
  render               progressive render → PPM/PNG (≡ DeviceTest.RayCast)
  bench                one-line JSON throughput (see bench.py for the headline)
"""

from __future__ import annotations

import argparse
import sys
import time


def _cmd_info(args) -> int:
    import jax

    from oclpathtracer_tpu.runtime import device_info, get_devices

    devs = get_devices()
    print(f"backend: {jax.default_backend()}  devices: {len(devs)}")
    for d in devs:
        info = device_info(d)
        print(f"  [{info.index}] {info.platform} {info.kind}"
              + (f"  mem={info.memory_total}" if info.memory_total else ""))
    return 0


def _cmd_render(args) -> int:
    import numpy as np

    from oclpathtracer_tpu import RenderConfig
    from oclpathtracer_tpu.render.image import write_png, write_ppm
    from oclpathtracer_tpu.runtime import enable_compilation_cache
    from oclpathtracer_tpu.scene import load_cornell_box

    enable_compilation_cache()
    scene = load_cornell_box(args.scene)
    cfg = RenderConfig(width=args.width, height=args.height, bounces=args.bounces,
                       seed=args.seed)

    profile_ctx = None
    if args.profile:
        from oclpathtracer_tpu.runtime.profiling import trace

        profile_ctx = trace(args.profile)
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    if args.integrator == "pallas":
        from oclpathtracer_tpu.kernels.megakernel import render_pallas

        img = render_pallas(scene, cfg, args.spp,
                            samples_per_call=min(args.spp, 64), scan=args.scan)
    elif args.integrator == "path":
        from oclpathtracer_tpu.render.driver import render_progressive

        img = render_progressive(scene, cfg, args.spp,
                                 samples_per_step=min(args.spp, 16),
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
    elif args.integrator == "ao":
        from oclpathtracer_tpu.core import rng
        from oclpathtracer_tpu.integrators.ao import render_ao

        img = render_ao(scene, cfg, rng.make_key(cfg.seed), spp=args.spp)
    elif args.integrator == "direct":
        from oclpathtracer_tpu.core import rng
        from oclpathtracer_tpu.integrators.direct import render_direct

        img = render_direct(scene, cfg, rng.make_key(cfg.seed), spp=args.spp)
    elif args.integrator == "primary":
        from oclpathtracer_tpu.integrators.primary import render_primary

        img = render_primary(scene, cfg)
    else:
        print(f"unknown integrator {args.integrator}", file=sys.stderr)
        return 2
    img = np.asarray(img)
    dt = time.perf_counter() - t0
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        print(f"profile trace written to {args.profile}")
    print(f"rendered {cfg.width}x{cfg.height} spp={args.spp} "
          f"integrator={args.integrator} in {dt:.2f}s mean={img.mean():.4f}")

    out = args.output
    if out.endswith(".ppm"):
        write_ppm(out, img, cfg.width, cfg.height,
                  reference_quirk=args.reference_quirk)
    else:
        write_png(out, img, cfg.width, cfg.height)
    print(f"wrote {out}")
    return 0


def _cmd_bench(args) -> int:
    import runpy

    runpy.run_path("bench.py", run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="oclpathtracer_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="device enumeration and queries")

    r = sub.add_parser("render", help="progressive render to PPM/PNG")
    r.add_argument("--scene", default=None, help="scene .bin (default: cornellbox)")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--bounces", type=int, default=16)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--integrator", default="pallas",
                   choices=["pallas", "path", "primary", "ao", "direct"])
    r.add_argument("--output", "-o", default="render.png")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--scan", default="auto",
                   choices=["auto", "parity", "fast", "tp"],
                   help="triangle-scan arithmetic for pallas: "
                        "reference-exact 'parity', division-free 'fast', or "
                        "triple-product 'tp' (auto = the fastest the scene's "
                        "materials support: tp, else fast, else parity)")
    r.add_argument("--reference-quirk", action="store_true",
                   help="reproduce the reference's double-gamma PPM export")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a device-timeline trace (xprof) to DIR")

    sub.add_parser("bench", help="run the headline benchmark")

    args = p.parse_args(argv)
    return {"info": _cmd_info, "render": _cmd_render, "bench": _cmd_bench}[
        args.command](args)


if __name__ == "__main__":
    sys.exit(main())
