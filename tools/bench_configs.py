#!/usr/bin/env python3
"""Per-config benchmark table for BASELINE.md (configs 1-5).

Runs each BASELINE.json config on the current backend and prints one JSON
line per config: forward Mrays/s (and fwd+bwd for the north-star config),
plus the validation status (which golden test covers it).

Usage: python tools/bench_configs.py [config ...]   (default: all)
Env: NART_BENCH_SIZE_SCALE to shrink image sizes for smoke runs.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = {
    # name: (scene path, asset root, w, h, spp, bounces, extra params,
    #        validation note)
    "1_glassSphere": (
        "/root/reference/input/scenes/glassSphere.json", "/root/reference",
        512, 512, 16, 10, {"roughening_factor": 0.2},
        "tests/test_golden.py::test_glass_sphere_golden",
    ),
    "2_cornell": (
        "tests/golden/cornell.json", "/root/reference",
        128, 128, 64, 6, {},
        "tests/test_golden.py::test_cornell_golden{,_64spp}",
    ),
    "3_texture_env": (
        "tests/golden/texture_env.json", "/root/reference",
        128, 128, 256, 6, {"roughening_factor": 0.25},
        "tests/test_golden.py::test_texture_env_golden",
    ),
    "4_caustic_sweep": (
        "/root/reference/input/scenes/glassSphere.json", "/root/reference",
        256, 256, 1024, 10, {"roughening_factor": None},  # sweep below
        "tests/test_golden.py::test_glass_sphere_golden (geometry/materials)"
        " + tools/bench_configs.py sweep rows",
    ),
    "5_volume": (
        "tests/golden/volume_blob.json", "tests/golden",
        96, 96, 256, 64, {"integrator": "volume"},
        "tests/test_golden.py::test_volume_golden",
    ),
    # the production-size volume row
    "5b_volume_256": (
        "tests/golden/volume_blob.json", "tests/golden",
        256, 256, 256, 64, {"integrator": "volume"},
        "tests/test_golden.py::test_volume_golden (same scene, 96^2)",
    ),
}


def run_config(name):
    import jax

    from nart_jax import render as render_mod
    from nart_jax.scene import load_scene

    scene_path, root, w, h, spp, bounces, extra, validation = CONFIGS[name]
    scale = float(os.environ.get("NART_BENCH_SIZE_SCALE", "1"))
    w, h = int(w * scale), int(h * scale)
    scene = load_scene(os.path.join(REPO, scene_path)
                       if not scene_path.startswith("/") else scene_path,
                       asset_root=root if root.startswith("/")
                       else os.path.join(REPO, root))

    sweep = [None]
    if name == "4_caustic_sweep":
        sweep = [0.0, 0.2, 0.5]  # rougheningFactor sweep (reference -r)
        extra = {}
        if os.environ.get("NART_BENCH_SWEEP_ONLY_R02"):
            sweep = [0.2]

    rows = []
    for r in sweep:
        kw = dict(image_width=w, image_height=h, spp=spp, bounces=bounces,
                  filter_width=2.0, **{k: v for k, v in extra.items()
                                       if v is not None})
        if r is not None:
            kw["roughening_factor"] = r
        params = render_mod.RenderParams(**kw)
        sess = render_mod.RenderSession(scene, params)
        film, rays = sess.render(with_stats=True)  # compile + warm scene
        # 3 repetitions, report the MEDIAN and the min-max spread: round-4
        # same-config numbers spread ~15% across runs (thermal/launch
        # jitter), so single-shot numbers over-claim precision
        times = []
        for _ in range(3):
            t0 = time.time()
            film, rays = sess.render(with_stats=True)
            times.append(time.time() - t0)
        dt = sorted(times)[1]
        row = {
            "config": name if r is None else f"{name}_r{r}",
            "size": f"{w}x{h}", "spp": spp,
            "fwd_s": round(dt, 2),
            "fwd_mrays_per_s": round(rays / dt / 1e6, 3),
            "fwd_spread_pct": round(
                100.0 * (max(times) - min(times)) / dt, 1
            ),
            "rays": int(rays),
            "validated_by": validation,
        }
        # fwd+bwd (path-replay backprop) on the differentiable-north-star
        # configs: config 1 and the 1024-spp config 4 (at one sweep point,
        # r=0.2 — BASELINE.json's metric config)
        if name == "1_glassSphere" or (name == "4_caustic_sweep" and r == 0.2):
            import bench as bench_mod

            rc = {}
            bench_mod.fwdbwd_run(sess, rounds_cache=rc)  # compile
            btimes = []
            for _ in range(2):
                t0 = time.time()
                rays_b, _ = bench_mod.fwdbwd_run(sess, rounds_cache=rc)
                btimes.append(time.time() - t0)
            bwd_s = min(btimes)
            row["fwdbwd_s"] = round(bwd_s, 2)
            row["fwdbwd_mrays_per_s"] = round(rays_b / bwd_s / 1e6, 3)
            row["fwdbwd_spread_pct"] = round(
                100.0 * (max(btimes) - min(btimes)) / bwd_s, 1
            )
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    names = sys.argv[1:] or list(CONFIGS)
    all_rows = []
    for n in names:
        all_rows.extend(run_config(n))
    out = os.environ.get("NART_BENCH_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(all_rows, f, indent=1)
        print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
