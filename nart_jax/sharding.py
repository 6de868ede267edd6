"""Multi-device scaling: pixel-lane sharding over a device mesh.

Role parity: the reference's only parallelism is TBB bucket data-parallelism
on one host (render.cpp:152-177).  The equivalent here (SURVEY.md §5):

  * device mesh over the host's cards (`jax.sharding.Mesh`, axis "tiles")
  * pixel lanes sharded across the mesh with `shard_map` — each device
    renders its lanes into a full-size film and the films are `psum`-merged
    over NVLink, exactly the reference's tile overlap-add, but as a collective
  * parameter gradients: `jax.grad` through the sharded render inserts the
    psum all-reduce for the (replicated) parameter pytree automatically,
    overlapped with the replay backward pass by XLA's scheduler
  * multi-host: `jax.distributed.initialize()` then the same mesh spans all
    processes (jax.devices() is global); host 0 gathers the film for EXR

Determinism: lanes are seeded by absolute pixel id, so every sample
decision is identical for any device count; the image differs only by the
float association order of the film/psum merge (tests/test_sharding.py
asserts 1e-6 agreement on the CPU mesh).  Padding lanes
(when pixel count % devices != 0) are aimed at an off-film coordinate; the
splat bounds mask drops their contribution entirely.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .render import RenderParams, render_film


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh2(n_tiles: int, n_spp: int) -> Mesh:
    """2-D mesh: pixel-row slabs x spp slabs.

    The spp axis is the renderer's sequence-parallel analog (SURVEY.md §5
    "long-context"): per-pixel samples are independent and the film
    accumulation is associative, so sharding spp across devices is exact.
    At the 1024-spp north star it is the natural second axis once row
    slabs stop scaling (few rows per device starves the work queue).
    """
    devs = jax.devices()[: n_tiles * n_spp]
    return Mesh(np.array(devs).reshape(n_tiles, n_spp), ("tiles", "spp"))


def init_distributed(**kwargs):
    """Multi-host entry: call before any jax op on pod slices."""
    jax.distributed.initialize(**kwargs)


def is_primary() -> bool:
    """True on the process that should own side effects (EXR write, logs)."""
    return jax.process_index() == 0


def _put(mesh: Mesh, tree, spec):
    """device_put a pytree with a NamedSharding — the multi-controller-safe
    way to feed shard_map: every process passes the same global (numpy)
    values and jax slices out its addressable shards."""
    s = jax.sharding.NamedSharding(mesh, spec)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), tree)


def render_sharded(
    scene,
    bvh,
    params: RenderParams,
    mesh: Mesh,
    render_w,
    render_h,
    total_w,
    total_h,
    filter_bounds,
):
    """Render with pixel lanes sharded over the mesh.

    wavefront="balanced" (the default) shards pixel ROWS: each device runs
    its own work-queue wavefront over its row slab's (pixel, sample) items
    and splats a slab film; slabs (whose filter-tap borders overlap) are
    psum-merged.  Per-item RNG streams are keyed by GLOBAL ids, so the
    image is invariant to the device count.  Other modes shard pixel lanes
    over the per-spp loop (render_film) with a full-film psum.

    Returns the merged (totalH, totalW, 5) film (replicated on all devices).
    """
    if params.wavefront == "balanced":
        return _render_sharded_balanced(
            scene, bvh, params, mesh, render_w, render_h, total_w, total_h,
            filter_bounds,
        )
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = render_w * render_h
    pad = (-n) % n_dev
    idx = np.arange(n + pad, dtype=np.int32)
    # padding lanes splat far outside the film -> dropped by the bounds mask
    px = np.where(idx < n, idx % render_w, total_w + 64).astype(np.int32)
    py = np.where(idx < n, idx // render_w, total_h + 64).astype(np.int32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def shard_render(scene, bvh, px, py):
        film, _rays = render_film(
            scene, bvh, params, px, py, total_w, total_h, filter_bounds
        )
        return jax.lax.psum(film, axis)

    return jax.jit(shard_render)(
        _put(mesh, jax.tree_util.tree_map(np.asarray, scene), P()),
        _put(mesh, bvh, P()),
        _put(mesh, px, P(axis)),
        _put(mesh, py, P(axis)),
    )


@functools.lru_cache(maxsize=8)
def _balanced_program(
    params: RenderParams,
    mesh: Mesh,
    render_w,
    render_h,
    total_w,
    total_h,
    filter_bounds,
):
    """Striped-row x spp-slab sharding of the balanced work-queue wavefront.

    A 1-D mesh ("tiles") shards pixel rows; a 2-D mesh ("tiles", "spp" —
    make_mesh2) additionally shards the spp axis: each device traces its
    (row set, sample slab) block of the global (pixel, sample) item set.
    Rows are assigned ROUND-ROBIN in strips of 8 (device d owns strips d,
    d + n_dev, ...), not as one contiguous slab: path length is spatially
    systematic (a subject-free top slab finishes in half the rounds of the
    slab holding the glass), and per-device wall time is proportional to
    its round count, so contiguous slabs gave only 83% round-count
    balance at 8 devices where striping gives ~97% (a round-count proxy on
    the CPU mesh, tools/scaling_evidence.py; wall time on the GPU is not
    measured by it).  Strips stay 8 rows tall for traversal
    coherence (>= the filter support, so same-device strip splats never
    overlap).  RNG streams are keyed by GLOBAL (pixel, sample) ids
    (chunk_base carries the spp offset), so every sample decision is
    identical for any mesh shape; films psum-merge over both axes.

    Returns the jitted program (scene, bvh, dev_ids[, spp0s]) -> film,
    cached per configuration so that repeated renders reuse it.
    """
    from . import film as film_mod
    from . import rng, sampling
    from .integrators import path as path_integrator

    axes = mesh.axis_names
    n_row_dev = mesh.shape[axes[0]]
    n_spp_dev = mesh.shape[axes[1]] if len(axes) > 1 else 1
    fb = filter_bounds
    k = 2 * fb + 1
    # strip height: >= 8 for ray coherence, >= k+1 so strips of the SAME
    # device (separated by (n_row_dev-1)*strip_rows more rows) never
    # overlap in the splat's dynamic_update_slice
    strip_rows = render_h if n_row_dev == 1 else max(8, k + 1)
    strips_per_dev = -(-(-(-render_h // strip_rows)) // n_row_dev)
    rows = strips_per_dev * strip_rows  # local rows per device
    rows_total = rows * n_row_dev
    p_local = rows * render_w
    n_pix_total = render_w * render_h
    spp = params.spp
    spp_local = -(-spp // n_spp_dev)  # samples per device (may pad)

    in_axis = (P(axes[0]), P(axes[1])) if len(axes) > 1 else (P(axes[0]),)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P()) + in_axis,
        out_specs=P(),
        check_vma=False,
    )
    def shard_render(scene, bvh, dev_ids, *spp0s_opt):
        # the device/slab ids arrive as SHARDED inputs rather than
        # axis_index: with check_vma=False, a psum whose operand derives
        # from no sharded input is silently miscompiled (treated as
        # replicated); a sharded operand lineage keeps it a real
        # all-reduce
        dev = dev_ids[0]
        spp0 = spp0s_opt[0][0] if spp0s_opt else jnp.int32(0)
        local_row = jnp.arange(rows, dtype=jnp.int32)
        # round-robin strips: local strip i -> global strip i*n_dev + dev
        row_map = (
            (local_row // strip_rows * n_row_dev + dev) * strip_rows
            + local_row % strip_rows
        )
        local = jnp.arange(p_local, dtype=jnp.int32)
        px = local % render_w
        py = row_map[local // render_w]
        real = py < render_h  # padded rows trace but never splat
        # per-pixel Latin-square jitters from the reference's pixel
        # streams: the FULL spp draw per pixel (the square depends on
        # total spp), then this device's sample slab sliced out
        state = rng.seed(py * total_w + px)
        samples, _ = sampling.latin_square(state, spp)
        samples = jnp.swapaxes(samples, 0, 1)  # (spp, P_local, 2)
        # zero-pad so the slice never clamps (a clamped start would pair
        # trailing-device jitters with the wrong global sample ids); padded
        # rows are masked out of the splat below
        pad_s = n_spp_dev * spp_local - spp
        if pad_s:
            samples = jnp.pad(samples, ((0, pad_s), (0, 0), (0, 0)))
        samples = jax.lax.dynamic_slice(
            samples, (spp0, 0, 0), (spp_local, p_local, 2)
        )

        if params.integrator == "volume":
            from .integrators import volume as volume_integrator

            tracer = volume_integrator.trace_balanced
        else:
            tracer = path_integrator.trace_balanced
        la, rays, _ = tracer(
            scene,
            bvh,
            samples,
            params,
            render_w,
            rows,
            chunk_base=spp0,
            n_lanes=params.lanes,
            n_pix_total=n_pix_total,
            row_map=row_map,
        )

        table = jnp.asarray(film_mod.filter_table())
        # layout fence: keep the splat's image-shaped layouts from leaking
        # onto the wavefront loop carry (the single-chip path goes further
        # and puts trace and splat in separate jit programs; inside
        # shard_map they must share one)
        la = jax.lax.optimization_barrier(la)
        # padded spp rows (dynamic_slice clamp when spp % n_spp_dev != 0)
        # trace but never splat
        s_real = spp0 + jnp.arange(spp_local, dtype=jnp.int32) < spp
        real_mask = real[None, :] & s_real[:, None]
        film_pad = jnp.zeros((rows_total + k, total_w + k, 5), jnp.float32)
        # per-strip splat + placement: local rows within one strip are
        # globally adjacent, but STRIP boundaries are not — each strip
        # splats its own (strip_rows + k) window placed at its global row
        p_strip = strip_rows * render_w
        for i in range(strips_per_dev):
            sl = slice(i * p_strip, (i + 1) * p_strip)
            acc = film_mod.splat_windows(
                samples[:, sl], la[:, sl], params.filter_width, table,
                render_w, strip_rows, fb,
                real_mask=real_mask[:, sl],
            )
            row0 = (i * n_row_dev + dev) * strip_rows
            film_pad = jax.lax.dynamic_update_slice(
                film_pad, acc[:, : total_w + k], (row0, 0, 0)
            )
        film_pad = jax.lax.psum(film_pad, axes)
        return film_pad[:total_h, :total_w]

    return jax.jit(shard_render)


def _render_sharded_balanced(
    scene, bvh, params, mesh, render_w, render_h, total_w, total_h,
    filter_bounds,
):
    axes = mesh.axis_names
    n_row_dev = mesh.shape[axes[0]]
    dev_ids = np.arange(n_row_dev, dtype=np.int32)
    args = [
        _put(mesh, jax.tree_util.tree_map(np.asarray, scene), P()),
        _put(mesh, bvh, P()),
        _put(mesh, dev_ids, P(axes[0])),
    ]
    if len(axes) > 1:
        spp_local = -(-params.spp // mesh.shape[axes[1]])
        spp0s = np.arange(mesh.shape[axes[1]], dtype=np.int32) * spp_local
        args.append(_put(mesh, spp0s, P(axes[1])))
    program = _balanced_program(params, mesh, render_w, render_h, total_w,
                                total_h, filter_bounds)
    return program(*args)


def _replay_slabs(params, mesh, width, height):
    """Per-device inputs of the sharded replay: (local_items, specs,
    row0s, spp0s, rows).  local_items(row0, spp0) -> (jitters, cotangent)
    of this device's (row slab, sample slab); padding carries no
    cotangent."""
    from . import rng, sampling

    axes = mesh.axis_names
    n_row_dev = mesh.shape[axes[0]]
    n_spp_dev = mesh.shape[axes[1]]
    w, h = width, height
    total_w = w + 2 * int(np.ceil(params.filter_width))
    rows = -(-h // n_row_dev)
    spp = params.spp
    spp_local = -(-spp // n_spp_dev)

    def local_items(row0, spp0):
        local = jnp.arange(rows * w, dtype=jnp.int32)
        px = local % w
        py = row0 + local // w
        state = rng.seed(py * total_w + px)
        samples, _ = sampling.latin_square(state, spp)
        samples = jnp.swapaxes(samples, 0, 1)
        pad_s = n_spp_dev * spp_local - spp
        if pad_s:
            samples = jnp.pad(samples, ((0, pad_s), (0, 0), (0, 0)))
        samples = jax.lax.dynamic_slice(
            samples, (spp0, 0, 0), (spp_local, rows * w, 2)
        )
        s_real = spp0 + jnp.arange(spp_local, dtype=jnp.int32) < spp
        real = (py < h)[None, :] & s_real[:, None]
        cot = jnp.where(
            real[..., None],
            jnp.ones((spp_local, rows * w, 4)).at[..., 3].set(0.0),
            0.0,
        )
        return samples, cot

    # slab offsets arrive as SHARDED inputs rather than axis_index (see
    # _render_sharded_balanced: a psum whose operand has no sharded
    # lineage is miscompiled under check_vma=False)
    specs = (P(), P(axes[0]), P(axes[1]))
    row0s = jnp.arange(n_row_dev, dtype=jnp.int32) * rows
    spp0s = jnp.arange(n_spp_dev, dtype=jnp.int32) * spp_local
    return local_items, specs, row0s, spp0s, rows


def sharded_replay_rounds(scene, bvh, theta, params, mesh, width, height):
    """Static round count for sharded_replay_step: the balanced forward's
    measured rounds, max over devices."""
    from . import grad as grad_mod
    from .integrators import path as path_integrator

    local_items, specs, row0s, spp0s, rows = _replay_slabs(
        params, mesh, width, height
    )

    def rounds_fn(theta, row0s, spp0s):
        samples, _ = local_items(row0s[0], spp0s[0])
        _, _, rounds = path_integrator.trace_balanced(
            grad_mod.put_params(scene, theta), bvh, samples, params, width,
            rows, chunk_base=spp0s[0], pix_offset=row0s[0] * width,
            n_pix_total=width * height,
        )
        return jax.lax.pmax(rounds, mesh.axis_names)

    fn = jax.shard_map(rounds_fn, mesh=mesh, in_specs=specs, out_specs=P(),
                       check_vma=False)
    return int(jax.jit(fn)(theta, row0s, spp0s))


def sharded_replay_step(scene, bvh, params, mesh, width, height, n_rounds):
    """The sharded fwd+bwd training step, jitted: theta -> ((loss,
    unfinished), grads) of the summed RGB radiance of a balanced render
    over a (pixel-row slabs x spp slabs) mesh (make_mesh2).

    Each device replays the balanced work queue over its (rows, samples)
    block of the global (pixel, sample) items for n_rounds rounds (see
    sharded_replay_rounds); RNG streams are keyed by global ids, so loss
    and gradients equal the one-device values up to summation order.
    unfinished > 0 means n_rounds was too small.
    """
    from . import grad as grad_mod
    from .integrators import path as path_integrator

    local_items, specs, row0s, spp0s, rows = _replay_slabs(
        params, mesh, width, height
    )
    axes = mesh.axis_names

    def loss_fn(theta, row0s, spp0s):
        samples, cot = local_items(row0s[0], spp0s[0])
        loss, _, unfinished = path_integrator.trace_balanced_loss(
            grad_mod.put_params(scene, theta), bvh, samples, cot, params,
            width, rows, n_rounds, chunk_base=spp0s[0],
            pix_offset=row0s[0] * width, n_pix_total=width * height,
        )
        return jax.lax.psum(loss, axes), jax.lax.psum(unfinished, axes)

    fn = jax.shard_map(loss_fn, mesh=mesh, in_specs=specs,
                       out_specs=(P(), P()), check_vma=False)

    def loss(theta):
        return fn(theta, row0s, spp0s)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))
