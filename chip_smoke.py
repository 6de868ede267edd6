#!/usr/bin/env python3
"""Smoke run of nart-jax on one NVIDIA GPU: the quickest proof that the
renderer and its replay backward run on the card and give right answers.

    python chip_smoke.py                 # phases 0-4 on one card
    python chip_smoke.py --full          # phase 1 at the scene's 256 spp
    python chip_smoke.py --traversal     # time the three intersectors
    python chip_smoke.py --cards 4       # only the sharded path, 4 cards

Phases (one JSON line each, with the card's name and power limit):

  0 device     JAX's first device must be a GPU; no CPU fallback.
  1 forward    tests/fixtures/macbeth/macbeth.json at its own 1280x720,
               filter width and roughening, 16 of its 256 spp, through
               RenderSession and the CLI; writes the EXR.
  2 goldens    renders on the card vs the reference-binary goldens in
               tests/golden (tolerances of tests/test_golden.py); GPU vs
               CPU per pixel on Cornell (regen wavefront); repeat and
               checkpoint-resume identity.
  3 kernel     the Pallas traversal vs geometry.intersect_brute on >= 1M
               rays (macbeth camera rays + one bounce).
  4 backward   a path-replay gradient step at 1280x720; GPU vs CPU
               gradients on Cornell 32x32.

The last line of standard output is {"ok": true, "device": {...}}; any
failure raises and exits non-zero without it.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MACBETH = os.path.join(HERE, "tests", "fixtures", "macbeth")
GOLDEN = os.path.join(HERE, "tests", "golden")
OUT = os.path.join(HERE, "out", "chip_smoke")

# the GPU-vs-CPU comparisons need the CPU backend beside the GPU one
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import nart_jax  # noqa: E402,F401  (sets the compile cache)
from nart_jax import film, grad, render, sharding  # noqa: E402
from nart_jax.accel import build_bvh  # noqa: E402
from nart_jax.scene import load_scene  # noqa: E402

CARD = None  # nvidia-smi's "name, power.limit" line(s)
_T0 = [time.perf_counter()]


def card_info():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(x.strip() for x in r.stdout.strip().splitlines())


def emit(phase, **kw):
    """One JSON line; phase_s is the wall time since the previous line."""
    now = time.perf_counter()
    kw["phase_s"] = now - _T0[0]
    _T0[0] = now
    print(json.dumps({"phase": phase, "card": CARD, **kw}), flush=True)


def peak_bytes(dev=None):
    stats = (dev or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*a, **kw))
    return out, time.perf_counter() - t0


def grad_diff(g, g_ref):
    """Worst leaf of two gradient pytrees: (name, sum|g - ref| / sum|ref|).

    An L1 measure, not a per-entry one: two differently compiled programs
    can round a texture coordinate to the neighbouring texel for a
    sample, moving one contribution between adjacent texels while every
    sum agrees."""
    worst = ("", 0.0)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g),
                            jax.tree_util.tree_leaves(g_ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        rel = float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))
        if rel > worst[1]:
            worst = (jax.tree_util.keystr(path), rel)
    return worst


def macbeth():
    return load_scene(os.path.join(MACBETH, "macbeth.json"),
                      asset_root=MACBETH)


def cornell():
    return load_scene(os.path.join(GOLDEN, "cornell.json"),
                      asset_root=MACBETH)


def image_of(sess, buf):
    p = sess.params
    return np.asarray(film.finalize(jnp.asarray(buf), p.image_width,
                                    p.image_height, sess.filter_bounds))


# ---------------------------------------------------------------- phase 0
def phase_device():
    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"JAX's first device is {d.platform!r}, not a GPU")
    from nart_jax import _native, exr

    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(devs), jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=jax.config.jax_compilation_cache_dir,
         native_core=_native.get() is not None,
         native_exr=exr._get_native() is not None)


# ---------------------------------------------------------------- phase 1
def phase_forward(full):
    from nart_jax import cli, exr

    scene_path = os.path.join(MACBETH, "macbeth.json")
    overrides = {} if full else {"spp": 16}
    [params] = render.load_sessions(scene_path, overrides)
    sess = render.RenderSession(macbeth(), params)
    (buf, rays), cold = timed(sess.render, with_stats=True)
    (buf, rays), warm = timed(sess.render, with_stats=True)
    img = image_of(sess, buf)
    check(np.isfinite(img).all(), "forward image has non-finite pixels")
    check(img[..., :3].mean() > 1e-3, "forward image is black")

    # the CLI as a user runs it (same compiled programs, so warm)
    out = os.path.join(OUT, "macbeth")
    argv = [scene_path, out, "--assetRoot", MACBETH, "--timing"]
    if not full:
        argv += ["-s", "16"]
    t0 = time.perf_counter()
    check(cli.main(argv) == 0, "CLI render failed")
    cli_s = time.perf_counter() - t0
    exr_img = exr.read(out + ".exr")
    check(exr_img.shape == img.shape and np.isfinite(exr_img).all(),
          "CLI EXR has the wrong shape or non-finite pixels")
    emit("forward", scene="macbeth.json", width=params.image_width,
         height=params.image_height, spp=params.spp,
         filter_width=params.filter_width,
         roughening=params.roughening_factor, bounces=params.bounces,
         accel=sess.params.accel, wavefront=params.wavefront,
         compile_s=cold - warm, render_s=warm, rays=rays,
         mrays_per_s=rays / warm / 1e6, cli_s=cli_s,
         peak_bytes_in_use=peak_bytes(), mean_rgb=float(img[..., :3].mean()),
         exr=os.path.relpath(out + ".exr", HERE))


# ---------------------------------------------------------------- phase 2
def golden_stats(ours, golden_name, mean_tol, block_tol, block_frac):
    """tests/test_golden.py's statistical comparison, as numbers."""
    from nart_jax import exr

    ref = exr.read(os.path.join(GOLDEN, golden_name))[..., :3]
    o = ours[..., :3]
    check(ref.shape == o.shape, f"{golden_name}: shape {o.shape}")
    mean_rel = abs(o.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    h, w = ref.shape[:2]
    rb = ref[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    ob = o[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    rm, om = rb.mean((1, 3, 4)), ob.mean((1, 3, 4))
    frac_ok = float((np.abs(om - rm) / np.maximum(rm, 0.05) < block_tol)
                    .mean())
    ok = mean_rel < mean_tol and frac_ok >= block_frac
    return dict(golden=golden_name, mean_rel=float(mean_rel),
                mean_tol=mean_tol, block_frac_ok=frac_ok,
                block_tol=block_tol, block_frac_min=block_frac, ok=ok)


def phase_goldens():
    rows = []
    cases = [
        # scene, params, golden, (mean_tol, block_tol, block_frac)
        (cornell(), render.resolve_params({}, dict(
            image_width=128, image_height=128, spp=16, bounces=6)),
         "cornell_128x128_16spp.exr", (0.02, 0.1, 0.9)),
        (macbeth(), render.resolve_params({}, dict(
            image_width=128, image_height=128, spp=16)),
         "macbeth_128x128_16spp.exr", (0.01, 0.05, 0.95)),
    ]
    vol_path = os.path.join(GOLDEN, "volume_blob.json")
    cases.append((load_scene(vol_path), render.load_sessions(vol_path)[0],
                  "volume_blob_96x96_32spp.exr", (0.02, 0.05, 0.95)))
    for scene, params, golden, tols in cases:
        sess = render.RenderSession(scene, params)
        img, secs = timed(sess.image)
        rows.append({**golden_stats(img, golden, *tols), "seconds": secs,
                     "accel": sess.params.accel,
                     "integrator": params.integrator})
    check(all(r["ok"] for r in rows), f"golden mismatch: {rows}")

    # GPU vs CPU, same process: diffuse Cornell, reference stream layout
    params = render.resolve_params({}, dict(
        image_width=64, image_height=64, spp=4, bounces=6,
        wavefront="regen"))
    scene = cornell()
    gpu_sess = render.RenderSession(scene, params)
    gpu = gpu_sess.image()
    gpu_again = gpu_sess.image()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = render.RenderSession(
            scene, dataclasses.replace(params, accel="bvh")).image()
    rtol, floor = 1e-4, 1e-3
    rel = np.abs(gpu - cpu) / np.maximum(np.abs(cpu), floor)
    cmp = dict(max_rel=float(rel.max()), mean_rel=float(rel.mean()),
               pixels_over=int((rel > rtol).sum()), rtol=rtol,
               floor=floor, gpu_accel=gpu_sess.params.accel,
               cpu_accel="bvh",
               gpu_repeat_bit_identical=bool((gpu == gpu_again).all()))

    # checkpoint resume: 2 + 2 spp resumed vs 4 spp in one go
    ckpt = os.path.join(OUT, "cornell_resume.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    buf_full = gpu_sess.render(checkpoint_path=ckpt, checkpoint_every=2)
    buf_resumed = render.RenderSession(scene, params).render(
        checkpoint_path=ckpt, checkpoint_every=2, resume=True)
    cmp["resume_bit_identical"] = bool((buf_full == buf_resumed).all())
    cmp["resume_max_abs"] = float(np.abs(buf_full - buf_resumed).max())
    emit("goldens", goldens=rows, gpu_vs_cpu=cmp,
         peak_bytes_in_use=peak_bytes())
    check(cmp["pixels_over"] == 0,
          f"GPU and CPU Cornell differ beyond rtol {rtol}: {cmp}")
    check(cmp["resume_max_abs"] <= 1e-6 * float(np.abs(buf_full).max()),
          f"checkpoint resume differs: {cmp}")


# ---------------------------------------------------------------- phase 3
def parity_rays(scene, bvh, w=1280, h=720, seed=0):
    """macbeth camera rays + one cosine-weighted bounce of every hit."""
    from nart_jax import camera
    from nart_jax.pallas_accel import intersect_pallas

    g = np.random.default_rng(seed)
    idx = np.arange(w * h, dtype=np.int32)
    o, d = camera.cast_rays(
        scene.cam_to_world, scene.fov, w, h, jnp.asarray(idx % w),
        jnp.asarray(idx // w), jnp.asarray(g.random((w * h, 2), np.float32)))
    n_cam = w * h
    hit = intersect_pallas(o, d, jnp.zeros(n_cam), jnp.full(n_cam, np.inf),
                           bvh)
    ok = np.asarray(hit.tri) >= 0
    tri = np.asarray(scene.tri_v)[np.asarray(hit.tri)[ok]]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dd = np.asarray(d)[ok]
    nrm = np.where((np.sum(nrm * dd, -1) > 0)[:, None], -nrm, nrm)
    p = np.asarray(o)[ok] + np.asarray(hit.t)[ok, None] * dd
    # cosine-weighted hemisphere around the facing normal
    u1, u2 = g.random(len(p)), g.random(len(p))
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    a = np.where(np.abs(nrm[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                 [[1.0, 0.0, 0.0]])
    t1 = np.cross(nrm, a)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(nrm, t1)
    d2 = (r * np.cos(phi))[:, None] * t1 + (r * np.sin(phi))[:, None] * t2 \
        + np.sqrt(1 - u1)[:, None] * nrm
    o2 = p + 1e-3 * nrm
    rays_o = np.concatenate([np.asarray(o), o2]).astype(np.float32)
    rays_d = np.concatenate([np.asarray(d), d2]).astype(np.float32)
    return jnp.asarray(rays_o), jnp.asarray(rays_d)


def brute_batched(o, d, t_min, t_max, tri_v, batch=1 << 18):
    """intersect_brute in ray batches (keeps its (N, chunk) temporaries
    small); returns numpy (t, tri, u, v)."""
    from nart_jax.geometry import intersect_brute

    fn = jax.jit(intersect_brute)
    outs = []
    for i in range(0, o.shape[0], batch):
        sl = slice(i, i + batch)
        outs.append(fn(o[sl], d[sl], t_min[sl], t_max[sl], tri_v))
    return [np.concatenate([np.asarray(getattr(x, f)) for x in outs])
            for f in ("t", "tri", "u", "v")]


def phase_kernel():
    from nart_jax.pallas_accel import intersect_pallas, occluded_pallas

    scene = macbeth()
    bvh = build_bvh(np.asarray(scene.tri_v))
    tri_v = jnp.asarray(scene.tri_v)
    o, d = parity_rays(scene, bvh)
    n = o.shape[0]
    check(n >= 1_000_000, f"only {n} parity rays")
    t_min = jnp.zeros(n)
    t_inf = jnp.full(n, np.inf)
    near_fn = jax.jit(intersect_pallas)
    any_fn = jax.jit(occluded_pallas)
    near, _ = timed(near_fn, o, d, t_min, t_inf, bvh)
    near, near_s = timed(near_fn, o, d, t_min, t_inf, bvh)
    bt, btri, bu, bv = brute_batched(o, d, t_min, t_inf, tri_v)
    _, brute_s = timed(brute_batched, o, d, t_min, t_inf, tri_v)
    kt, ktri = np.asarray(near.t), np.asarray(near.tri)

    same = ktri == btri
    both = (ktri >= 0) & (btri >= 0)
    dt = np.abs(np.where(both, kt, 0.0) - np.where(both, bt, 0.0))
    tie = both & ~same & (dt <= 1e-6 * np.abs(bt))
    # a ray through the silhouette edge of an open mesh: one side's f32
    # arithmetic accepts it, the other's rejects it (barycentric margin
    # below 1e-5 on the triangle the accepting side hit)
    vmis = (ktri >= 0) != (btri >= 0)
    margin = np.minimum(np.minimum(bu, bv), 1.0 - bu - bv)
    kh = vmis & (ktri >= 0)
    if kh.any():
        ku = np.asarray(near.u)[kh]
        kv = np.asarray(near.v)[kh]
        margin[kh] = np.minimum(np.minimum(ku, kv), 1.0 - ku - kv)
    graze = vmis & (np.abs(margin) < 1e-5)
    bad = ~same & ~tie & ~graze
    t_rel = dt[same & both] / np.abs(bt[same & both])

    # any-hit: unbounded, and a shadow-like finite t_max per ray
    occ, any_s = timed(any_fn, o, d, t_min, t_inf, bvh)
    occ, any_s = timed(any_fn, o, d, t_min, t_inf, bvh)
    g = np.random.default_rng(1)
    t_fin = jnp.asarray(g.uniform(0.0, 4.0, n).astype(np.float32))
    occ_fin = np.asarray(any_fn(o, d, t_min, t_fin, bvh))
    near_fin = np.asarray(near_fn(o, d, t_min, t_fin, bvh).tri) >= 0
    row = dict(
        rays=int(n), triangles=int(scene.tri_v.shape[0]),
        precision="f32; the kernel does no dot, so no TF32",
        hits=int((btri >= 0).sum()), tri_equal=int(same.sum()),
        ties=int(tie.sum()), silhouette_grazes=int(graze.sum()),
        mismatches=int(bad.sum()),
        t_max_rel=float(t_rel.max()) if t_rel.size else 0.0,
        anyhit_equal_nearest=bool((np.asarray(occ) == (ktri >= 0)).all()),
        anyhit_equal_nearest_finite_tmax=bool((occ_fin == near_fin).all()),
        kernel_nearest_s=near_s, kernel_anyhit_s=any_s, brute_s=brute_s,
        kernel_mrays_per_s=n / near_s / 1e6,
        brute_mrays_per_s=n / brute_s / 1e6,
    )
    emit("kernel", **row, peak_bytes_in_use=peak_bytes())
    check(row["mismatches"] == 0, f"kernel vs brute: {row}")
    check(row["t_max_rel"] <= 1e-5, f"kernel t off: {row}")
    check(row["anyhit_equal_nearest"]
          and row["anyhit_equal_nearest_finite_tmax"],
          f"any-hit disagrees with nearest hit: {row}")


# ---------------------------------------------------------------- phase 4
def replay_inputs(scene, params, w, h):
    total_w = w + 2 * int(np.ceil(params.filter_width))
    idx = jnp.arange(w * h, dtype=jnp.int32)
    samples, _ = render._setup_jit(idx % w, idx // w, total_w, params.spp)
    cot = jnp.ones(samples.shape[:2] + (4,)).at[..., 3].set(0.0)
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    return scene, grad.get_params(scene), samples, cot


def replay_step(scene, params, w, h, accel=None):
    """(loss, grads, rays, cold_s, warm_s) of one path-replay step."""
    params = dataclasses.replace(
        params, accel=accel or render.resolve_accel(params.accel))
    scene, theta, samples, cot = replay_inputs(scene, params, w, h)
    bvh = build_bvh(np.asarray(scene.tri_v))
    out, cold = timed(grad.radiance_weighted_loss_and_grad, scene, theta,
                      bvh, samples, cot, params, w, h)
    n_rounds = out[3]
    out2, warm = timed(grad.radiance_weighted_loss_and_grad, scene, theta,
                       bvh, samples, cot, params, w, h, n_rounds=n_rounds)
    return out2, out, cold, warm


def phase_backward():
    scene_path = os.path.join(MACBETH, "macbeth.json")
    [params] = render.load_sessions(scene_path, {"spp": 4})
    w, h = params.image_width, params.image_height
    (loss, grads, rays, n_rounds), first, cold, warm = replay_step(
        macbeth(), params, w, h)
    leaves = jax.tree_util.tree_leaves(grads)
    finite = all(bool(np.isfinite(np.asarray(x)).all()) for x in leaves)
    repeat_equal = all(
        bool((np.asarray(a) == np.asarray(b)).all())
        for a, b in zip(leaves, jax.tree_util.tree_leaves(first[1])))

    # GPU vs CPU gradients on Cornell 32x32 @ 4 spp
    cp = render.resolve_params({}, dict(image_width=32, image_height=32,
                                        spp=4, bounces=6))
    (_, g_gpu, _, _), _, _, _ = replay_step(cornell(), cp, 32, 32)
    with jax.default_device(jax.devices("cpu")[0]):
        (_, g_cpu, _, _), _, _, _ = replay_step(cornell(), cp, 32, 32,
                                                accel="bvh")
    rtol = 1e-4
    leaf, worst = grad_diff(g_gpu, g_cpu)
    emit("backward", scene="macbeth.json", width=w, height=h,
         spp=params.spp, accel=render.resolve_accel(params.accel),
         loss=float(loss), n_rounds=int(n_rounds), rays=float(rays),
         first_step_s=cold, step_s=warm,
         mrays_per_s=float(rays) / warm / 1e6, grad_leaves=len(leaves),
         grads_finite=finite, repeat_bit_identical=repeat_equal,
         cornell_gpu_vs_cpu_rel_l1=worst, worst_leaf=leaf, rtol=rtol,
         peak_bytes_in_use=peak_bytes())
    check(finite, "non-finite gradient")
    check(worst <= rtol, f"GPU and CPU gradients differ: {worst}")


# ------------------------------------------------------------- --traversal
def sphere_mesh(level=8, seed=0):
    """A displaced icosphere: 20 * 4**level triangles (1,310,720 at 8).
    The displacement is a smooth function of position drawn from the
    seed, so shared vertices stay shared (watertight)."""
    g = np.random.default_rng(seed)
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                  [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]])
    tri = v[f]
    tri /= np.linalg.norm(tri, axis=-1, keepdims=True)
    for _ in range(level):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = [m / np.linalg.norm(m, axis=-1, keepdims=True)
                      for m in ((a + b), (b + c), (c + a))]
        tri = np.stack([np.stack(x, 1) for x in
                        ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                         (ab, bc, ca))], 1).reshape(-1, 3, 3)
    k = g.normal(size=(6, 3)) * 3.0
    ph = g.uniform(0, 2 * np.pi, 6)
    disp = sum(np.sin(tri @ k[i] + ph[i]) for i in range(6)) * 0.02
    return (tri * (1.0 + disp[..., None])).astype(np.float32)


def sphere_scene(tri):
    from nart_jax import testing

    base = testing.simple_scene(("plastic",), roughness=0.3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dataclasses.replace(
        base, tri_v=tri, tri_n=np.repeat(n[:, None], 3, 1),
        tri_uv=np.zeros((len(tri), 3, 2), np.float32),
        tri_mesh=np.zeros(len(tri), np.int32), n_tris=len(tri))


def sort_key(o, d):
    """Direction octant + origin Morton cell (the coherence key the
    retired cluster kernel sorted rays by)."""
    lo = jnp.min(o, 0)
    u = jnp.clip((o - lo) / jnp.maximum(jnp.max(o, 0) - lo, 1e-12), 0, 1)
    q = (u * 255.0).astype(jnp.uint32)

    def expand8(v):
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    morton = (expand8(q[:, 0]) << 2) | (expand8(q[:, 1]) << 1) \
        | expand8(q[:, 2])
    octant = ((d[:, 0] > 0) * 4 + (d[:, 1] > 0) * 2 + (d[:, 2] > 0)
              ).astype(jnp.uint32)
    return (octant << 24) | (morton >> 3)


def phase_traversal():
    """End-to-end time of each intersector: macbeth forward (phase 1's
    render), the macbeth replay step (phase 4's), and a generated
    1.3M-triangle sphere (traversal alone and a forward render)."""
    from nart_jax.accel import intersect_bvh
    from nart_jax.geometry import intersect_brute
    from nart_jax.pallas_accel import intersect_pallas

    scene_path = os.path.join(MACBETH, "macbeth.json")
    [fwd] = render.load_sessions(scene_path, {"spp": 16})
    [bwd] = render.load_sessions(scene_path, {"spp": 4})
    rows = {}
    for accel in ("pallas", "bvh", "brute"):
        p = dataclasses.replace(fwd, accel=accel)
        sess = render.RenderSession(macbeth(), p)
        (_, rays), cold = timed(sess.render, with_stats=True)
        (_, rays), warm = timed(sess.render, with_stats=True)
        (_, _, brays, _), _, bcold, bwarm = replay_step(
            macbeth(), bwd, bwd.image_width, bwd.image_height, accel=accel)
        rows[accel] = dict(forward_s=warm, forward_compile_s=cold - warm,
                           forward_mrays_per_s=rays / warm / 1e6,
                           replay_step_s=bwarm,
                           replay_mrays_per_s=float(brays) / bwarm / 1e6)
        emit("traversal_macbeth", accel=accel, **rows[accel])

    # ray sorting ahead of the kernel: does coherence pay?
    scene = macbeth()
    bvh = build_bvh(np.asarray(scene.tri_v))
    o, d = parity_rays(scene, bvh)
    n = o.shape[0]
    t0, ti = jnp.zeros(n), jnp.full(n, np.inf)
    walk = jax.jit(intersect_pallas)

    @jax.jit
    def sorted_walk(o, d, t0, ti, bvh):
        perm = jnp.argsort(sort_key(o, d))
        h = intersect_pallas(o[perm], d[perm], t0, ti, bvh)
        inv = jnp.zeros_like(perm).at[perm].set(
            jnp.arange(n, dtype=perm.dtype))
        return jax.tree_util.tree_map(lambda x: x[inv], h)

    timed(walk, o, d, t0, ti, bvh)
    timed(sorted_walk, o, d, t0, ti, bvh)
    _, plain_s = timed(walk, o, d, t0, ti, bvh)
    _, sort_s = timed(sorted_walk, o, d, t0, ti, bvh)
    emit("traversal_sorting", rays=int(n), unsorted_s=plain_s,
         sorted_incl_sort_s=sort_s)

    sphere_traversal(forward=True)


def sphere_traversal(forward):
    """A generated 1.3M-triangle mesh: each intersector alone on 2^20
    camera rays (brute on 2^14), and with forward=True a 512x512 @ 4 spp
    render with the kernel and the lockstep walk."""
    from nart_jax import camera
    from nart_jax.accel import intersect_bvh
    from nart_jax.geometry import intersect_brute
    from nart_jax.pallas_accel import intersect_pallas

    tri = sphere_mesh()
    sph = sphere_scene(tri)
    bvh = build_bvh(tri)
    w = 1024
    idx = jnp.arange(w * w, dtype=jnp.int32)
    g = np.random.default_rng(2)
    o, d = camera.cast_rays(sph.cam_to_world, sph.fov, w, w, idx % w,
                            idx // w, jnp.asarray(g.random((w * w, 2),
                                                           np.float32)))
    n = w * w
    t0, ti = jnp.zeros(n), jnp.full(n, np.inf)
    fns = {"pallas": (jax.jit(intersect_pallas), n),
           "bvh": (jax.jit(intersect_bvh), n),
           "brute": (jax.jit(intersect_brute), 1 << 14)}
    for accel, (fn, m) in fns.items():
        arg = bvh if accel != "brute" else jnp.asarray(tri)
        timed(fn, o[:m], d[:m], t0[:m], ti[:m], arg)
        _, secs = timed(fn, o[:m], d[:m], t0[:m], ti[:m], arg)
        row = dict(accel=accel, triangles=len(tri), rays=int(m),
                   isect_s=secs, isect_mrays_per_s=m / secs / 1e6)
        if forward and accel != "brute":
            p = render.resolve_params({}, dict(
                image_width=512, image_height=512, spp=4, accel=accel))
            sess = render.RenderSession(sph, p)
            timed(sess.render, with_stats=True)
            (_, rays), secs = timed(sess.render, with_stats=True)
            row.update(forward_512_4spp_s=secs,
                       forward_mrays_per_s=rays / secs / 1e6)
        emit("traversal_sphere", **row)


# ---------------------------------------------------------------- --cards
def phase_cards(n):
    devs = jax.devices()
    check(len(devs) >= n, f"--cards {n}: only {len(devs)} devices")
    scene_path = os.path.join(MACBETH, "macbeth.json")
    [params] = render.load_sessions(scene_path, {"spp": 16})
    scene = macbeth()
    sess = render.RenderSession(scene, params)
    one = image_of(sess, timed(sess.render)[0])
    _, one_s = timed(sess.render)
    emit("cards_one", scene="macbeth.json", width=params.image_width,
         height=params.image_height, spp=params.spp, one_card_wall_s=one_s)
    for name, mesh in (("1d", sharding.make_mesh(n)),
                       ("2d", sharding.make_mesh2(2, n // 2))):
        ids = sorted(d.id for d in mesh.devices.flat)
        check(len(set(ids)) == n, f"mesh {name} uses devices {ids}")
        args = (scene, sess.bvh, sess.params, mesh, sess.render_w,
                sess.render_h, sess.total_w, sess.total_h,
                sess.filter_bounds)
        timed(sharding.render_sharded, *args)
        buf, secs = timed(sharding.render_sharded, *args)
        img = image_of(sess, buf)
        rel = np.abs(img - one) / np.maximum(np.abs(one), 1e-3)
        busy = [peak_bytes(d) for d in devs[:n]]
        row = dict(mesh=name, devices=ids, wall_s=secs,
                   max_rel=float(rel.max()),
                   pixels_over_1e_4=int((rel > 1e-4).sum()),
                   peak_bytes_per_device=busy)
        emit("cards_render", cards=n, **row)
        check(all(b and b > 0 for b in busy), f"idle device: {busy}")
        check(row["pixels_over_1e_4"] == 0,
              f"sharded film differs from one card: {row}")

    # the sharded fwd+bwd step vs phase 4's one-card replay step
    [gp] = render.load_sessions(scene_path, {"spp": 4})
    w, h = gp.image_width, gp.image_height
    (l1, g1, _, n_rounds), _, _, s1 = replay_step(scene, gp, w, h)
    gp = dataclasses.replace(gp, accel=render.resolve_accel(gp.accel))
    scn = jax.tree_util.tree_map(jnp.asarray, scene)
    step = sharding.sharded_replay_step(
        scn, sess.bvh, gp, sharding.make_mesh2(2, n // 2), w, h, n_rounds)
    theta = grad.get_params(scn)
    timed(step, theta)
    ((ln, unfinished), gn), sn = timed(step, theta)
    leaf, worst = grad_diff(gn, g1)
    rtol = 1e-3
    emit("cards_grad", cards=n, width=w, height=h, spp=gp.spp,
         n_rounds=n_rounds, unfinished=int(unfinished), loss_1=float(l1),
         loss_n=float(ln), grad_rel_l1=worst, worst_leaf=leaf, rtol=rtol,
         one_card_step_s=s1, sharded_step_s=sn)
    check(int(unfinished) == 0, "sharded replay truncated")
    check(abs(float(ln) - float(l1)) <= 1e-4 * abs(float(l1)),
          "sharded loss differs")
    check(worst <= rtol, f"sharded gradients differ: {leaf} {worst}")


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="phase 1 at the scene's own 256 spp")
    ap.add_argument("--traversal", action="store_true",
                    help="also time the pallas, bvh and brute intersectors")
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1: run only the sharded path on N cards")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    CARD = card_info()
    print(f"card: {CARD}", flush=True)
    phase_device()
    if args.cards > 1:
        phase_cards(args.cards)
    else:
        phase_forward(args.full)
        phase_goldens()
        phase_kernel()
        phase_backward()
        if args.traversal:
            phase_traversal()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
