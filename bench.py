#!/usr/bin/env python3
"""Benchmark: Mrays/s/chip forward+backward on the glassSphere config.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Config (BASELINE.md #1 / north star): glassSphere.json geometry/materials at
512x512; forward pass at 16 spp and a forward+backward (path-replay) step;
the reported metric is fwd+bwd Mrays/s/chip.

vs_baseline: the reference publishes no numbers, so the baseline was
generated by building the reference in-environment (tools/refbuild) and
timing it on the same config (BASELINE.md "Measured reference numbers"):
glassSphere 512x512 @16spp forward render = 321.66 s CPU.  vs_baseline is
the wall-clock speedup of our forward render over that number at the
identical config; for other sizes/spp the reference time is scaled
linearly in pixel-samples (render cost is per-camera-sample).

Env knobs: NART_BENCH_SPP (default 16), NART_BENCH_SIZE (default 512),
NART_BENCH_MODE (fwdbwd|fwd, default fwdbwd).
"""

import json
import os
import sys
import time

import numpy as np


def _load_scene():
    from nart_jax.scene import load_scene
    from nart_jax.testing import simple_scene

    ref = "/root/reference/input/scenes/glassSphere.json"
    if os.path.exists(ref):
        return load_scene(ref, asset_root="/root/reference")
    return simple_scene(("glass", "glass", "lambert"), priorities=[2, 3, 0])


def fwdbwd_run(sess, spp=None, chunk=16, rounds_cache=None):
    """One full fwd+bwd pass (path-replay over the balanced wavefront).

    Per chunk, a cheap forward measures the round count, then a
    statically-bounded, per-round-checkpointed replay runs under
    value_and_grad.  Gradients accumulate across chunks on host (the loss
    is a sum over samples, so this is exact).  Returns (rays, grads);
    reuse rounds_cache across calls to skip the measuring forwards.
    """
    import jax
    import jax.numpy as jnp

    from nart_jax import grad as grad_mod
    from nart_jax import rng, sampling

    params = sess.params
    size_w, size_h = params.image_width, params.image_height
    spp = spp or params.spp
    scene_j = sess.scene_dev
    theta0 = grad_mod.get_params(scene_j)
    n = size_w * size_h
    idx = jnp.arange(n, dtype=jnp.int32)
    px, py = idx % size_w, idx // size_w
    chunk = min(spp, chunk)

    @jax.jit
    def setup(px, py):
        state = rng.seed(py * sess.total_w + px)
        s, _ = sampling.latin_square(state, spp)
        return jnp.swapaxes(s, 0, 1)  # (spp, N, 2)

    cot = jnp.ones((chunk, n, 4), jnp.float32).at[..., 3].set(0.0)
    if rounds_cache is None:
        rounds_cache = {}
    samples = setup(px, py)
    rays = 0.0
    grads = None
    for i in range(0, spp, chunk):
        loss, g, r, nr = grad_mod.radiance_weighted_loss_and_grad(
            scene_j, theta0, sess.bvh, samples[i : i + chunk], cot,
            params, size_w, size_h, chunk_base=jnp.int32(i),
            n_rounds=rounds_cache.get(i),
        )
        rounds_cache[i] = nr
        rays += float(r)
        grads = g if grads is None else jax.tree_util.tree_map(
            jnp.add, grads, g
        )
    jax.block_until_ready(grads)
    return rays, grads


def main():
    import jax
    import jax.numpy as jnp

    from nart_jax import grad as grad_mod
    from nart_jax import render as render_mod
    from nart_jax.integrators import path as path_integrator
    from nart_jax import camera, rng, sampling

    size = int(os.environ.get("NART_BENCH_SIZE", "512"))
    spp = int(os.environ.get("NART_BENCH_SPP", "16"))
    mode = os.environ.get("NART_BENCH_MODE", "fwdbwd")

    scene = _load_scene()
    params = render_mod.RenderParams(
        image_width=size, image_height=size, spp=spp, bounces=10,
        filter_width=2.0, roughening_factor=0.2,
    )
    sess = render_mod.RenderSession(scene, params)

    # ---- forward: full film render with ray stats
    t0 = time.time()
    film, rays_fwd = sess.render(with_stats=True)  # includes compile
    compile_s = time.time() - t0
    t0 = time.time()
    film, rays_fwd = sess.render(with_stats=True)
    fwd_s = time.time() - t0
    fwd_mrays = rays_fwd / fwd_s / 1e6

    result = {"fwd_mrays_per_s": fwd_mrays, "fwd_s": fwd_s,
              "compile_s": compile_s, "rays": rays_fwd}
    for k, v in result.items():
        print(f"# {k}: {v}", file=sys.stderr, flush=True)

    if mode == "fwdbwd":
        rounds_cache = {}
        fwdbwd_run(sess, rounds_cache=rounds_cache)  # compile
        t0 = time.time()
        rays_b, _ = fwdbwd_run(sess, rounds_cache=rounds_cache)
        bwd_s = time.time() - t0
        fwdbwd_mrays = rays_b / bwd_s / 1e6
        result.update(fwdbwd_mrays_per_s=fwdbwd_mrays, fwdbwd_s=bwd_s)
        print(f"# fwdbwd_mrays_per_s: {fwdbwd_mrays}", file=sys.stderr)
        print(f"# fwdbwd_s: {bwd_s}", file=sys.stderr)
        value = fwdbwd_mrays
        metric = f"Mrays/s/chip fwd+bwd glassSphere {size}x{size}@{spp}spp"
    else:
        value = fwd_mrays
        metric = f"Mrays/s/chip fwd glassSphere {size}x{size}@{spp}spp"

    # Reference CPU wall-clock for glassSphere 512x512@16spp forward
    # (BASELINE.md, measured via tools/refbuild): 321.66 s.  Scale by
    # pixel-sample count for non-default sizes.
    ref_s = 321.66 * (size * size * spp) / (512 * 512 * 16)
    vs = ref_s / fwd_s

    print(json.dumps({
        "metric": metric,
        "value": round(value, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(vs, 3),
    }))


if __name__ == "__main__":
    main()
