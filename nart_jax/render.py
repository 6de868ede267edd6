"""Render sessions: parameter resolution, the jitted spp loop, EXR output.

Parity: src/core/render.cpp (RenderSession, LoadSessions,
ParseRenderParamArguments) and main.cpp.  The reference's bucket/TBB
decomposition maps to: one wavefront lane per pixel, spp iterated inside one
jit-compiled `lax.fori_loop`, Gaussian splats scatter-added into a single
film buffer (film.py — mathematically identical to the tile merge).

Parameter precedence (render.cpp:327-414): CLI overrides > per-session JSON
> defaults (64x64, bucket 16, spp 1, bounces 10, filterWidth 1,
rougheningFactor 0 clamped to [0,1]).

The reference renders whole buckets clamped to totalWidth, so when the image
size is not bucket-divisible, pixels in [W, min(ceil(W/bs)*bs, W+2*fb))
are rendered and splat into the film (render.cpp:162-173) — reproduced via
render_w/render_h.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import camera, exr, film, rng, sampling
from .accel import build_bvh, resolve_accel_kind
from .integrators import path as path_integrator
from .scene import SceneData, load_scene


@dataclass(frozen=True)
class RenderParams:
    integrator: str = "path"  # "path" | "volume"
    image_width: int = 64
    image_height: int = 64
    bucket_size: int = 16
    spp: int = 1
    bounces: int = 10
    filter_width: float = 1.0
    roughening_factor: float = 0.0
    # extras (not part of the reference's JSON schema)
    # "auto" resolves per backend (accel.resolve_accel_kind): the one-launch
    # Pallas walk on a GPU, the lockstep LBVH walk elsewhere
    accel: str = "auto"  # "auto" | "bvh" | "brute" | "pallas"
    # MIS strategy toggles (reference compile-time BSDF_SAMPLING /
    # LIGHT_SAMPLING, pathintegrator.cpp:3-4); both on by default
    mis_bsdf: bool = True
    mis_light: bool = True
    # wavefront scheduling (path integrator only):
    #   "balanced" — work-queue: lanes pull (pixel, sample) items on death
    #     (prefix-sum queue, per-item RNG streams).  Fastest: round count
    #     ~ total work / lanes regardless of where long paths live.
    #   "regen"    — per-pixel sample regeneration; the reference's exact
    #     per-pixel RNG stream layout, bit-identical results to "spp".
    #   "spp"      — lockstep one-sample-per-pass loop (oracle-parity
    #     baseline).
    # All three are deterministic and converge to the same image; only
    # "regen"/"spp" reproduce the reference's stream layout bit-exactly.
    wavefront: str = "balanced"
    # samples per wavefront chunk (one jitted while_loop); 0 = auto
    spp_chunk: int = 0
    # work-slot lanes for wavefront="balanced"; 0 = auto
    lanes: int = 0


_DEFAULTS = RenderParams()


resolve_accel = resolve_accel_kind  # re-export (accel.py owns the policy)


def resolve_params(session_json: dict, overrides: dict) -> RenderParams:
    """CLI > JSON > defaults, with rougheningFactor clamped to [0,1]."""
    keys = {
        "integrator": "integrator",
        "imageWidth": "image_width",
        "imageHeight": "image_height",
        "bucketSize": "bucket_size",
        "spp": "spp",
        "bounces": "bounces",
        "filterWidth": "filter_width",
        "rougheningFactor": "roughening_factor",
        # extension keys (not part of the reference schema)
        "accel": "accel",
        "wavefront": "wavefront",
        "lanes": "lanes",
        "sppChunk": "spp_chunk",
    }
    vals = {}
    for jkey, field_name in keys.items():
        if field_name in overrides and overrides[field_name] is not None:
            vals[field_name] = overrides[field_name]
        elif jkey in session_json and session_json[jkey] is not None:
            vals[field_name] = session_json[jkey]
        else:
            vals[field_name] = getattr(_DEFAULTS, field_name)
    vals["roughening_factor"] = min(max(float(vals["roughening_factor"]), 0.0), 1.0)
    for k in ("image_width", "image_height", "bucket_size", "spp", "bounces",
              "lanes", "spp_chunk"):
        vals[k] = int(vals[k])
    vals["filter_width"] = float(vals["filter_width"])
    return RenderParams(**vals)


def load_sessions(scene_path: str, overrides: Optional[dict] = None):
    """LoadSessions parity: one RenderParams per renderSessions entry."""
    import json

    with open(scene_path) as f:
        doc = json.load(f)
    overrides = overrides or {}
    return [
        resolve_params(s, overrides) for s in doc.get("renderSessions", [])
    ]


class RenderSession:
    """One render: scene + params -> film -> EXR."""

    def __init__(self, scene: SceneData, params: RenderParams, leaf_size=8):
        self.scene = scene
        self.params = params
        self.filter_bounds = int(np.ceil(params.filter_width))
        self.total_w = params.image_width + 2 * self.filter_bounds
        self.total_h = params.image_height + 2 * self.filter_bounds
        nbx = -(-params.image_width // params.bucket_size)
        nby = -(-params.image_height // params.bucket_size)
        self.render_w = min(nbx * params.bucket_size, self.total_w)
        self.render_h = min(nby * params.bucket_size, self.total_h)
        params = dataclasses.replace(
            params, accel=resolve_accel_kind(params.accel)
        )
        self.params = params
        self.bvh = build_bvh(np.asarray(scene.tri_v), leaf_size=leaf_size)
        # device-resident scene, transferred once: the pytree has dozens
        # of leaves, each its own host-to-device copy
        self._scene_dev = None

    @property
    def scene_dev(self):
        if self._scene_dev is None:
            self._scene_dev = jax.tree_util.tree_map(jnp.asarray, self.scene)
        return self._scene_dev

    def render(
        self,
        with_stats=False,
        progress=False,
        checkpoint_path=None,
        checkpoint_every=0,
        resume=False,
    ):
        """Returns the raw film buffer (totalH, totalW, 5).

        The spp loop runs in Python over one jit-compiled per-sample step
        (film and RNG state donated between iterations): same results as a
        fully fused program, but the compiled graph stays small — important
        both for compile latency and for scaling spp without recompiles.

        Checkpointing: the (contribution, filterWeightSum) film plus the
        per-pixel RNG states form a resumable sufficient statistic
        (SURVEY.md §5); a resumed render is bit-identical to an
        uninterrupted one.  Progress mirrors the reference's percentage
        logger (render.cpp:138-149), per spp pass instead of per bucket.
        """
        import os
        import sys

        n = self.render_w * self.render_h
        idx = jnp.arange(n, dtype=jnp.int32)
        px = idx % self.render_w
        py = idx // self.render_w
        scene = self.scene_dev
        samples, state = _setup_jit(px, py, self.total_w, self.params.spp)
        buf = jnp.zeros((self.total_h, self.total_w, 5), jnp.float32)
        start_spp = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            from . import checkpoint as ckpt

            f0, s0, start_spp = ckpt.load(checkpoint_path, self.params)
            buf = jnp.asarray(f0)
            state = jnp.asarray(s0)
        rays_total = jnp.zeros((), jnp.float32)
        # chunked wavefront modes: balanced covers both integrators (the
        # volume integrator has its own work-queue machine); regen is
        # path-only (reference per-pixel stream parity has no volume analog)
        regen = self.params.wavefront == "balanced" or (
            self.params.wavefront == "regen"
            and self.params.integrator != "volume"
        )
        if regen:
            # chunk size: checkpoint granularity wins (boundaries must
            # align for bit-identical resume), else auto
            if checkpoint_path and checkpoint_every:
                chunk = min(checkpoint_every, self.params.spp)
            elif self.params.spp_chunk:
                chunk = min(self.params.spp_chunk, self.params.spp)
            else:
                chunk = min(self.params.spp, 32)
            bounds = list(range(start_spp, self.params.spp, chunk))
        else:
            bounds = list(range(start_spp, self.params.spp))
        for i in bounds:
            if regen:
                j = min(i + chunk, self.params.spp)
                # trace and splat are SEPARATE jit programs: fusing them
                # lets the splat's image-shaped layouts leak onto the
                # wavefront loop carries (minutes of extra compile,
                # optimization_barrier notwithstanding)
                if self.params.wavefront == "balanced":
                    la, rays, _ = _trace_balanced_jit(
                        samples[i:j], scene, self.bvh, self.params,
                        self.render_w, self.render_h, jnp.int32(i),
                    )
                else:
                    la, state, rays = _trace_regen_jit(
                        samples[i:j], scene, self.bvh, px, py, state,
                        self.params,
                    )
                buf = _splat_chunk_jit(
                    buf, samples[i:j], la, self.params,
                    self.render_w, self.render_h, self.filter_bounds,
                )
            else:
                j = i + 1
                buf, state, rays = _spp_step_jit(
                    buf,
                    state,
                    samples[i],
                    scene,
                    self.bvh,
                    px,
                    py,
                    self.params,
                    self.total_w,
                    self.total_h,
                    self.filter_bounds,
                    render_w=self.render_w,
                    render_h=self.render_h,
                )
            rays_total = rays_total + rays
            if progress:
                pct = int(j * 100 / self.params.spp)
                print(f"\r{pct}%", end="", file=sys.stderr, flush=True)
            if (
                checkpoint_path
                and checkpoint_every
                and j % checkpoint_every == 0
                and j < self.params.spp
            ):
                from . import checkpoint as ckpt

                ckpt.save(checkpoint_path, buf, state, j, self.params)
        if progress:
            print("\r100%", file=sys.stderr, flush=True)
        out = np.asarray(buf)
        if with_stats:
            return out, float(rays_total)
        return out

    def image(self) -> np.ndarray:
        """Final normalised RGBA image (H, W, 4)."""
        f = self.render()
        return np.asarray(
            film.finalize(
                jnp.asarray(f),
                self.params.image_width,
                self.params.image_height,
                self.filter_bounds,
            )
        )

    def write_exr(self, out_path: str):
        img = self.image()
        if not out_path.endswith(".exr"):
            out_path = out_path + ".exr"
        exr.write(out_path, img)
        return out_path


def render_film(
    scene, bvh, params, px, py, total_w, total_h, filter_bounds,
    grid_dims=None,
):
    """Render the given pixel lanes into a full-size film buffer.

    This is the traced core shared by the single-chip path (_render_jit) and
    the sharded path (sharding.py): each device renders its pixel-lane shard
    into a full (totalH, totalW, 5) buffer which is psum-merged — the exact
    analog of the reference's per-bucket tiles + overlap-add merge
    (render.cpp:152-203).
    """
    # per-pixel streams, seeded y*totalWidth+x (render.cpp:81-82)
    state = rng.seed(py * total_w + px)
    samples, state = sampling.latin_square(state, params.spp)
    samples = jnp.swapaxes(samples, 0, 1)  # (spp, N, 2): contiguous slices

    table = jnp.asarray(film.filter_table())
    buf = jnp.zeros((total_h, total_w, 5), jnp.float32)

    if params.integrator == "volume":
        from .integrators import volume as volume_integrator

        tracer = functools.partial(
            volume_integrator.trace, scene, bvh
        )
    else:
        tracer = functools.partial(path_integrator.trace, scene, bvh)

    def spp_body(i, carry):
        buf, state, rays = carry
        s = samples[i]
        o, d = camera.cast_rays(
            scene.cam_to_world,
            scene.fov,
            params.image_width,
            params.image_height,
            px,
            py,
            s,
        )
        l, a, state, r = tracer(o, d, state, params)
        l_alpha = jnp.concatenate([l, a[:, None]], axis=-1)
        if grid_dims is not None:
            # lanes form the full row-major pixel grid: dense splat
            buf = film.splat_grid(
                buf, s, l_alpha, params.filter_width, table,
                grid_dims[0], grid_dims[1], filter_bounds,
            )
        else:
            coords = jnp.stack(
                [
                    (px + filter_bounds).astype(jnp.float32) + s[..., 0],
                    (py + filter_bounds).astype(jnp.float32) + s[..., 1],
                ],
                axis=-1,
            )
            buf = film.splat(buf, coords, l_alpha, params.filter_width, table)
        return buf, state, rays + r

    buf, state, rays = jax.lax.fori_loop(
        0, params.spp, spp_body, (buf, state, jnp.zeros((), jnp.float32))
    )
    return buf, rays


@functools.partial(jax.jit, static_argnames=("total_w", "n_samples"))
def _setup_jit(px, py, total_w, n_samples):
    """Seed per-pixel streams + draw the Latin-square image samples.

    Samples come back spp-major (spp, N, 2) so the per-spp slice in the
    render loop is contiguous (the (N, spp, 2) layout made each step's
    slice a strided 33MB gather at 512^2x16)."""
    state = rng.seed(py * total_w + px)
    samples, state = sampling.latin_square(state, n_samples)
    return jnp.swapaxes(samples, 0, 1), state


@functools.partial(
    jax.jit,
    static_argnames=(
        "params",
        "total_w",
        "total_h",
        "filter_bounds",
        "render_w",
        "render_h",
    ),
    donate_argnums=(0, 1),
)
def _spp_step_jit(
    buf,
    state,
    s,
    scene,
    bvh,
    px,
    py,
    params,
    total_w,
    total_h,
    filter_bounds,
    render_w=None,
    render_h=None,
):
    """One sample-per-pixel pass: trace the wavefront + splat into the film."""
    o, d = camera.cast_rays(
        scene.cam_to_world,
        scene.fov,
        params.image_width,
        params.image_height,
        px,
        py,
        s,
    )
    if params.integrator == "volume":
        from .integrators import volume as volume_integrator

        l, a, state, r = volume_integrator.trace(scene, bvh, o, d, state, params)
    else:
        l, a, state, r = path_integrator.trace(scene, bvh, o, d, state, params)
    l_alpha = jnp.concatenate([l, a[:, None]], axis=-1)
    table = jnp.asarray(film.filter_table())
    if render_w is not None:
        # lanes are the full row-major render_w x render_h grid: dense splat
        buf = film.splat_grid(
            buf, s, l_alpha, params.filter_width, table,
            render_w, render_h, filter_bounds,
        )
    else:
        coords = jnp.stack(
            [
                (px + filter_bounds).astype(jnp.float32) + s[..., 0],
                (py + filter_bounds).astype(jnp.float32) + s[..., 1],
            ],
            axis=-1,
        )
        buf = film.splat(buf, coords, l_alpha, params.filter_width, table)
    return buf, state, r


@functools.partial(
    jax.jit,
    static_argnames=("params", "render_w", "render_h", "n_lanes"),
)
def _trace_balanced_jit(
    samples_chunk, scene, bvh, params, render_w, render_h, chunk_base,
    n_lanes=0,
):
    """One balanced-wavefront chunk: work-queue over (pixel, sample) items
    (path/volume trace_balanced).  Returns (la, rays, rounds); the film
    splat runs in a separate jit (see render()).

    This is also grad.py's round-count measuring program (same jit cache
    entry): sharing it means a bench/training flow that already rendered
    forward pays ZERO extra compiles to measure its replay round counts.
    """
    if params.integrator == "volume":
        from .integrators import volume as volume_integrator

        # static strided assignment: bit-identical per-item results to the
        # work queue at ~2x the throughput (see _static_vol_machine)
        tracer = volume_integrator.trace_vol_static
    else:
        tracer = path_integrator.trace_balanced
    la, rays, rounds = tracer(
        scene,
        bvh,
        samples_chunk,
        params,
        render_w,
        render_h,
        chunk_base=chunk_base,
        n_lanes=n_lanes or params.lanes,
    )
    return la, rays, rounds


@functools.partial(
    jax.jit, static_argnames=("params",), donate_argnums=(5,)
)
def _trace_regen_jit(samples_chunk, scene, bvh, px, py, state, params):
    """One sample-regeneration chunk: all lanes run `chunk` samples back to
    back in a single while_loop (path_integrator.trace_regen); the film
    splat runs in a separate jit (see render())."""
    la, state, rays = path_integrator.trace_regen(
        scene, bvh, px, py, samples_chunk, state, params
    )
    return la, state, rays


@functools.partial(
    jax.jit,
    static_argnames=("params", "render_w", "render_h", "filter_bounds"),
    donate_argnums=(0,),
)
def _splat_chunk_jit(
    buf, samples_chunk, la, params, render_w, render_h, filter_bounds
):
    """Splat one chunk's per-sample radiance into the film buffer.

    Sample-sequential film fold (film.splat_grid): bit-identical to the
    per-spp loop for any chunking."""
    table = jnp.asarray(film.filter_table())
    return film.splat_grid(
        buf, samples_chunk, la, params.filter_width, table,
        render_w, render_h, filter_bounds,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "params",
        "render_w",
        "render_h",
        "total_w",
        "total_h",
        "filter_bounds",
    ),
)
def _render_jit(
    scene, bvh, params, render_w, render_h, total_w, total_h, filter_bounds
):
    n = render_w * render_h
    idx = jnp.arange(n, dtype=jnp.int32)
    px = idx % render_w
    py = idx // render_w
    buf, rays = render_film(
        scene, bvh, params, px, py, total_w, total_h, filter_bounds,
        grid_dims=(render_w, render_h),
    )
    return buf, rays


def render_scene_file(scene_path: str, overrides: Optional[dict] = None):
    """Load scene + sessions and render them all.  Yields (params, session)."""
    scn = load_scene(scene_path)
    for params in load_sessions(scene_path, overrides):
        yield params, RenderSession(scn, params)
