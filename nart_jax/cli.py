"""Flag-compatible CLI.  Parity: src/core/main.cpp + ParseRenderParamArguments.

Usage: nart-jax <scene.json> <outPath> [flags]
  --imageWidth/-w --imageHeight/-h --bucketSize/-b --spp/-s
  --bounces/-o --filterWidth/-f --rougheningFactor/-r
plus extras:
  --devices N   shard pixel lanes over the first N devices
  --assetRoot   base dir for scene-relative assets (default: auto)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="nart-jax", add_help=False)
    p.add_argument("scene")
    p.add_argument("out")
    p.add_argument("--imageWidth", "-w", type=int, dest="image_width")
    p.add_argument("--imageHeight", "-h", type=int, dest="image_height")
    p.add_argument("--bucketSize", "-b", type=int, dest="bucket_size")
    p.add_argument("--spp", "-s", type=int, dest="spp")
    p.add_argument("--bounces", "-o", type=int, dest="bounces")
    p.add_argument("--filterWidth", "-f", type=float, dest="filter_width")
    p.add_argument(
        "--rougheningFactor", "-r", type=float, dest="roughening_factor"
    )
    p.add_argument("--devices", type=int, default=None)
    p.add_argument(
        "--coordinator",
        type=str,
        default=None,
        metavar="HOST:PORT",
        help="multi-process rendering: jax.distributed coordinator address "
        "(pass the same value to every process)",
    )
    p.add_argument(
        "--numProcesses", type=int, default=None, dest="num_processes",
        help="multi-process rendering: total process count",
    )
    p.add_argument(
        "--processId", type=int, default=None, dest="process_id",
        help="multi-process rendering: this process's rank (0-based); "
        "rank 0 writes the EXR",
    )
    p.add_argument("--assetRoot", type=str, default=None)
    p.add_argument(
        "--accel",
        choices=("bvh", "brute", "pallas"),
        default=None,
        help="intersector (default: pallas on a GPU, bvh elsewhere): "
        "lockstep LBVH walk, streaming brute force, or the LBVH walk as "
        "one Pallas kernel (GPU only)",
    )
    p.add_argument(
        "--wavefront",
        choices=("balanced", "regen", "spp"),
        default=None,
        help="wavefront scheduler: balanced work queue (default, fastest), "
        "per-pixel sample regeneration, or lockstep per-spp passes "
        "(the latter two reproduce the reference's RNG stream layout "
        "bit-exactly)",
    )
    p.add_argument(
        "--lanes",
        type=int,
        default=None,
        help="work-slot lanes for --wavefront balanced (0 = auto)",
    )
    p.add_argument(
        "--platform",
        type=str,
        default=None,
        help="force a jax platform (e.g. cpu); overrides NART_PLATFORM",
    )
    p.add_argument(
        "--profile",
        type=str,
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the render into DIR "
        "(view with tensorboard / xprof)",
    )
    p.add_argument(
        "--timing",
        action="store_true",
        help="print per-phase timing (load / accel build / render / write) "
        "and rays/s to stderr",
    )
    p.add_argument("--help", action="help")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    platform = args.platform or os.environ.get("NART_PLATFORM")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    if args.coordinator:
        # multi-process (multi-host) mode: every process runs this same CLI
        # with its own --processId; the device mesh then spans all processes
        # (jax.devices() is global) and rank 0 writes the output
        from . import sharding

        sharding.init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    overrides = {
        k: getattr(args, k)
        for k in (
            "image_width",
            "image_height",
            "bucket_size",
            "spp",
            "bounces",
            "filter_width",
            "roughening_factor",
            "accel",
            "wavefront",
            "lanes",
        )
        if getattr(args, k) is not None
    }

    from . import render as render_mod
    from .scene import load_scene

    print(f"Loading {args.scene}...")
    t_load = time.time()
    scene = load_scene(args.scene, asset_root=args.assetRoot)
    t_load = time.time() - t_load
    if args.timing:
        print(f"# load: {t_load:.3f}s", file=sys.stderr)
    sessions = render_mod.load_sessions(args.scene, overrides)
    if not sessions:
        print(f"Failed to load sessions from {args.scene}", file=sys.stderr)
        return 1

    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)

    for i, params in enumerate(sessions):
        start = time.time()
        print("Rendering...")
        t_build = time.time()
        sess = render_mod.RenderSession(scene, params)
        t_build = time.time() - t_build
        if args.timing:
            print(f"# accel build: {t_build:.3f}s", file=sys.stderr)
        if args.coordinator or (args.devices and args.devices > 1):
            import jax
            import jax.numpy as jnp

            from . import film as film_mod
            from . import sharding

            mesh = sharding.make_mesh(args.devices)
            buf = sharding.render_sharded(
                scene, sess.bvh, params, mesh, sess.render_w, sess.render_h,
                sess.total_w, sess.total_h, sess.filter_bounds,
            )
            img = np.asarray(
                film_mod.finalize(
                    buf, params.image_width, params.image_height,
                    sess.filter_bounds,
                )
            )
            out_path = args.out if len(sessions) == 1 else f"{args.out}_{i}"
            if not out_path.endswith(".exr"):
                out_path += ".exr"
            from . import exr

            # the film is replicated across processes; only rank 0 writes
            # (every process writing the same path would race)
            if sharding.is_primary():
                print(f"Writing to {out_path}...")
                exr.write(out_path, img)
        else:
            out_path = args.out if len(sessions) == 1 else f"{args.out}_{i}"
            if args.timing:
                import jax.numpy as jnp

                from . import exr, film as film_mod

                t_render = time.time()
                buf, rays = sess.render(with_stats=True)
                t_render = time.time() - t_render
                print(
                    f"# render: {t_render:.3f}s  rays: {rays:.0f}  "
                    f"({rays / t_render / 1e6:.3f} Mrays/s)",
                    file=sys.stderr,
                )
                img = np.asarray(
                    film_mod.finalize(
                        jnp.asarray(buf),
                        params.image_width,
                        params.image_height,
                        sess.filter_bounds,
                    )
                )
                if not out_path.endswith(".exr"):
                    out_path += ".exr"
                print(f"Writing to {out_path}...")
                t_write = time.time()
                exr.write(out_path, img)
                print(
                    f"# write: {time.time() - t_write:.3f}s", file=sys.stderr
                )
            else:
                print(f"Writing to {out_path}.exr...")
                out_path = sess.write_exr(out_path)
        print(f"Completed in {time.time() - start:.6g}s")

    if args.profile:
        import jax

        jax.profiler.stop_trace()
        print(f"# profiler trace written to {args.profile}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
