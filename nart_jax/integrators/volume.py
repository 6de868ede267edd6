"""Wavefront volume integrator: null-scattering delta tracking.

Parity: src/integrators/volumeintegrator.cpp + SampleT_maj (media.h:128-181).
The per-ray random walk (absorb / scatter / null with a global majorant) is
flattened into a wavefront loop: each iteration performs one free-flight
extension attempt per live lane, with lanes in one of three logical phases —
NEW_RAY (fresh segment: draw the unused-u + mode uniforms, clip to the
medium AABB), IN_FLIGHT (extend t), or ESCAPED (final light pass).  RNG
draw sites match the reference's scalar order exactly:
  outer: u (unused by SampleT_maj but drawn — parity), uMode
  per flight step: exponential t draw; on null: uMode redraw; on scatter:
  2 phase-function draws.
Lights contribute only on escape (no NEE/MIS in volume mode); alpha is 1.

Differentiability: every event multiplies the throughput by its
probability RATIO p / stop_gradient(p) — value exactly 1, so forward
results and draw order are untouched, but gradients flow through the
event probabilities (sigma_a, sigma_s, density) exactly as in detached-
sampling path replay.  The majorant stays a detached static bound.

Three schedulers:
  * trace        — per-pixel lockstep (reference draw-order parity).
  * trace_balanced — work queue over (pixel, sample) items: a lane whose
    walk terminates pulls the next item via prefix sum, so null-collision-
    heavy media no longer idle lanes (same design as path.trace_balanced,
    incl. per-item murmur RNG streams keyed by global sample ids).
  * trace_vol_static — static strided item slices per lane (the default
    forward path): per-item results are bit-identical to trace_balanced,
    but the radiance lands in a static (local, lane) slot and jitters come
    from a one-hot over the per-lane slice, eliminating the queue's
    item-indexed scatter/gather that dominated its rounds (~2x faster;
    see _static_vol_machine).
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from .. import rng
from ..media import (clip_to_aabb, medium_properties_cells,
                     pack_density_cells)
from ..sampling import sample_exponential_decay, uniform_sample_sphere
from .path import _nearest_light, _path_stream_seed

INF = np.float32(np.inf)
_MAX_STEPS = 1_000_000  # safety cap; delta tracking terminates probabilistically


def _ratio(p, mask):
    """p / detach(p) where mask, else 1: unit-valued gradient carrier."""
    safe = jnp.where(mask & (p > 0.0), p, 1.0)
    return safe / jax.lax.stop_gradient(safe)


def _make_vol_step(scene, medium, params, n, defer_light=False):
    """One delta-tracking flight step for an n-lane wavefront.

    Returns (step, finish).  step(vs) -> (vs', died, esc) where vs is the
    VolState tuple and `died` marks lanes whose walk ended THIS step
    (absorbed, scatter-depth exhausted, or escaped).  With
    defer_light=False (lockstep modes) escape radiance is added inline and
    finish is a no-op; with defer_light=True escaped lanes only set `esc`
    and the caller applies finish(vs, esc_pending) ONCE after a batch of
    fused flight steps — the escape light pass is deterministic (no RNG)
    and (o, d, beta) freeze at escape, so deferral changes nothing but
    WHEN the full-wavefront _nearest_light cost is paid (once per round
    instead of once per flight step)."""
    sigma_maj = np.float32(medium.sigma_maj)
    bmin = jnp.asarray(medium.bounds_min)
    bmax = jnp.asarray(medium.bounds_max)
    # one-gather trilinear lookups: the cell table is built once per trace
    # (loop-invariant), not per flight step
    cells = pack_density_cells(medium.density)

    def step(vs):
        (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st, beta,
         l_out) = vs

        # --- NEW_RAY: SampleT_maj entry (media.h:128-140)
        setup = alive & new_ray
        _, st = rng.masked_next_float(st, setup)  # u: drawn, unused (parity)
        um_new, st = rng.masked_next_float(st, setup)
        u_mode = jnp.where(setup, um_new, u_mode)
        box_hit, t0, t1 = clip_to_aabb(o, d, bmin, bmax)
        t_cur = jnp.where(setup, jnp.maximum(0.0, t0), t_cur)
        t_exit = jnp.where(setup, t1, t_exit)
        # segment exhausted immediately (missed box / behind): escape
        esc_now = setup & (~box_hit | (t_cur + np.float32(1e-4) > t_exit))
        new_ray = jnp.where(setup, False, new_ray)

        # --- flight step (media.h:147-178)
        flying = alive & ~esc_now
        u_t, st = rng.masked_next_float(st, flying)
        t = t_cur + sample_exponential_decay(u_t, sigma_maj)
        left_segment = flying & (t >= t_exit)

        p = o + d * t[:, None]
        inside, s_a, s_s, le_med = medium_properties_cells(medium, cells, p)
        in_medium = flying & ~left_segment
        left_medium = in_medium & ~inside  # SampleMedium returned false

        sampling_lane = in_medium & inside
        p_absorb = s_a / sigma_maj
        p_scatter = s_s / sigma_maj
        pa_det = jax.lax.stop_gradient(p_absorb)
        ps_det = jax.lax.stop_gradient(p_scatter)
        absorb = sampling_lane & (u_mode < pa_det)
        scatter = sampling_lane & ~absorb & (u_mode < pa_det + ps_det)
        null = sampling_lane & ~absorb & ~scatter

        # event-probability ratios (== 1): gradients w.r.t. sigma/density
        beta = beta * _ratio(p_absorb, absorb)[:, None]
        beta = beta * _ratio(p_scatter, scatter)[:, None]
        beta = beta * _ratio(1.0 - p_absorb - p_scatter, null)[:, None]

        # absorb: L += Le * beta, terminate (volumeintegrator.cpp:30-35)
        l_out = l_out + jnp.where(absorb[:, None], le_med * beta, 0.0)

        # scatter: bounce++ > bounces -> terminate, else redirect
        over = scatter & (bounce > params.bounces)
        bounce = bounce + scatter.astype(jnp.int32)
        do_redirect = scatter & ~over
        s1, st = rng.masked_next_float(st, do_redirect)
        s2, st = rng.masked_next_float(st, do_redirect)
        w_new, _ = uniform_sample_sphere(jnp.stack([s1, s2], -1))
        o = jnp.where(do_redirect[:, None], p, o)
        d = jnp.where(do_redirect[:, None], w_new, d)
        new_ray = new_ray | do_redirect

        # null: redraw uMode, continue from t
        um2, st = rng.masked_next_float(st, null)
        u_mode = jnp.where(null, um2, u_mode)
        t_cur = jnp.where(null, t, t_cur)

        # escape: left the segment or the medium, or missed the box
        # (volumeintegrator.cpp:66-80)
        esc = esc_now | left_segment | left_medium
        if not defer_light:
            le, _, _ = _nearest_light(scene.lights, o, d,
                                      jnp.full((n,), INF))
            l_out = l_out + jnp.where(esc[:, None], le * beta, 0.0)

        died = alive & (absorb | over | esc)
        alive = alive & ~(absorb | over | esc)
        vs = (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st, beta,
              l_out)
        return vs, died, esc

    def finish(vs, esc_pending):
        """Apply the escape light pass to lanes that escaped since the
        last finish (deferred-light mode only)."""
        (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st, beta,
         l_out) = vs
        le, _, _ = _nearest_light(scene.lights, o, d, jnp.full((n,), INF))
        l_out = l_out + jnp.where(esc_pending[:, None], le * beta, 0.0)
        return (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st,
                beta, l_out)

    return step, finish


def _vol_state(n, o, d, state):
    return (
        jnp.ones((n,), bool),  # alive
        jnp.ones((n,), bool),  # new_ray
        jnp.zeros((n,), jnp.int32),  # bounce
        jnp.zeros((n,)),  # u_mode
        jnp.zeros((n,)),  # t_cur
        jnp.zeros((n,)),  # t_exit
        o,
        d,
        state,
        jnp.ones((n, 3)),  # beta (unit event ratios; pf == its own pdf)
        jnp.zeros((n, 3)),  # l_out
    )


def trace(scene, bvh, o, d, state, params):
    """Lockstep per-pixel walk.  Returns (L (N,3), alpha (N,), state, rays).

    rays counts walk segments (camera rays + scatter redirects) — the
    volume analog of the path integrator's per-bounce ray count.
    """
    n = o.shape[0]
    medium = scene.medium

    if medium is None:
        # no medium on the camera: every ray escapes immediately
        le, t_l, hit = _nearest_light(scene.lights, o, d, jnp.full((n,), INF))
        return le, jnp.ones((n,)), state, jnp.zeros((), jnp.float32)

    step, _ = _make_vol_step(scene, medium, params, n)

    def cond(carry):
        it, vs, rays = carry
        return jnp.any(vs[0]) & (it < _MAX_STEPS)

    def body(carry):
        it, vs, rays = carry
        rays = rays + jnp.sum((vs[0] & vs[1]).astype(jnp.float32))
        vs, _, _ = step(vs)
        return it + 1, vs, rays

    carry = (jnp.int32(0), _vol_state(n, o, d, state), jnp.zeros((), jnp.float32))
    _, vs, rays = jax.lax.while_loop(cond, body, carry)
    (_, _, _, _, _, _, _, _, state, _, l_out) = vs
    return l_out, jnp.ones((n,)), state, rays


def trace_diff(scene, bvh, o, d, state, params, n_steps=512):
    """Statically-bounded differentiable walk (reverse-AD variant of trace).

    Reverse AD cannot transpose a while_loop, so the flight loop runs a
    STATIC n_steps fori_loop with jax.checkpoint on the step body (the
    backward pass replays each step — the same path-replay discipline as
    grad.py).  Dead lanes are masked no-ops, so any n_steps >= the longest
    walk gives results identical to trace().

    Returns (L, alpha, state, rays, unfinished) — unfinished > 0 means
    n_steps was too small (gradient/radiance then missing tail terms).
    """
    n = o.shape[0]
    medium = scene.medium
    if medium is None:
        le, _, _ = _nearest_light(scene.lights, o, d, jnp.full((n,), INF))
        return (le, jnp.ones((n,)), state, jnp.zeros((), jnp.float32),
                jnp.zeros((), jnp.int32))

    step = jax.checkpoint(_make_vol_step(scene, medium, params, n)[0])

    def body(i, carry):
        vs, rays = carry
        rays = rays + jnp.sum((vs[0] & vs[1]).astype(jnp.float32))
        vs, _, _ = step(vs)
        return vs, rays

    vs, rays = jax.lax.fori_loop(
        0, n_steps, body,
        (_vol_state(n, o, d, state), jnp.zeros((), jnp.float32)),
    )
    alive, _, _, _, _, _, _, _, state, _, l_out = vs
    return (l_out, jnp.ones((n,)), state, rays,
            jnp.sum(alive.astype(jnp.int32)))


def _no_medium_la(scene, samples, params, render_w, pix_offset):
    """No medium on the camera: every item escapes to the light pass.

    Evaluated one spp-slice at a time (lax.map over the chunk axis) so peak
    memory stays O(n_pix) regardless of the chunk size.
    """
    from .. import camera as camera_mod

    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    pix = jnp.arange(n_pix, dtype=jnp.int32) + jnp.int32(pix_offset)
    px = pix % render_w
    py = pix // render_w

    def one_spp(jit):
        o, d = camera_mod.cast_rays(
            scene.cam_to_world, scene.fov, params.image_width,
            params.image_height, px, py, jit,
        )
        le, _, _ = _nearest_light(scene.lights, o, d, jnp.full((n_pix,), INF))
        return jnp.concatenate([le, jnp.ones((n_pix, 1))], axis=-1)

    la = jax.lax.map(one_spp, samples)  # (spp_chunk, n_pix, 4)
    return (
        la,
        jnp.asarray(float(spp_chunk * n_pix), jnp.float32),
        jnp.zeros((), jnp.int32),
    )


def _balanced_vol_machine(
    scene, medium, samples, params, render_w, render_h, chunk_base, n_lanes,
    pix_offset, n_pix_total, row_map=None,
):
    """Shared work-queue machinery (volume analog of path._balanced_machine).

    Returns (core0, step_round) where step_round(core) ->
    (core', died, la, item_before, segment_starts): `la` is the RGBA
    radiance of lanes whose walk ended this round, `item_before` the item
    they carried, `segment_starts` the number of fresh segments begun (the
    volume ray counter).
    """
    from .. import camera as camera_mod
    from .path import _next_pow2

    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if not n_lanes:
        n_lanes = 1 << max(
            14, int(np.ceil(np.log2(max(12.0 * float(total) ** 0.5, 1.0))))
        )
        n_lanes = min(n_lanes, 1 << 19, _next_pow2(total))
    n = n_lanes
    if n_pix_total is None:
        n_pix_total = n_pix
    samples_flat = samples.reshape(total, 2)

    def spawn(item):
        it = jnp.clip(item, 0, total - 1)
        jit = samples_flat[it]
        s = it // n_pix
        lp = it % n_pix
        if row_map is None:
            pix = lp + jnp.int32(pix_offset)
            px = pix % render_w
            py = pix // render_w
        else:
            px = lp % render_w
            py = row_map[lp // render_w]
            pix = py * render_w + px
        o, d = camera_mod.cast_rays(
            scene.cam_to_world, scene.fov, params.image_width,
            params.image_height, px, py, jit,
        )
        gid = (jnp.uint32(chunk_base) + s.astype(jnp.uint32)) * jnp.uint32(
            n_pix_total
        ) + pix.astype(jnp.uint32)
        return o, d, _path_stream_seed(gid)

    item0 = jnp.arange(n, dtype=jnp.int32)
    o0, d0, st0 = spawn(item0)
    vs0 = _vol_state(n, o0, d0, st0)
    vs0 = (item0 < total,) + vs0[1:]
    core0 = (vs0, item0, jnp.int32(min(n, total)))

    step, finish = _make_vol_step(scene, medium, params, n,
                                  defer_light=True)
    # fused flight steps per round: the respawn prefix-sum/scatter and the
    # (deferred) escape light pass are per-ROUND costs, so K flight steps
    # per round amortise both K-fold.  Lanes that die mid-batch idle for
    # the remainder (masked no-ops) — cheap against the ~10+ steps a
    # typical delta-tracking walk takes.  K=1 reproduces the old schedule;
    # results are identical for any K (draws are per-lane masked, the
    # light pass draws no RNG).
    k_steps = int(_os.environ.get("NART_VOL_FUSE", "4"))

    def step_round(core):
        vs, item, head = core
        died = jnp.zeros((n,), bool)
        esc_pend = jnp.zeros((n,), bool)
        segment_starts = jnp.zeros((), jnp.float32)
        for _ in range(k_steps):
            segment_starts = segment_starts + jnp.sum(
                (vs[0] & vs[1]).astype(jnp.float32)
            )
            vs, died_k, esc_k = step(vs)
            died = died | died_k
            esc_pend = esc_pend | esc_k
        vs = finish(vs, esc_pend)
        (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st, beta,
         l_out) = vs
        # RGB only: volume alpha is constant 1 (reference parity), so the
        # per-round radiance scatter moves 3 elements per item, not 4 —
        # the scatter is the largest single per-round cost (element-bound)
        la = l_out
        item_before = item

        # pull next queue items (prefix sum over this round's deaths)
        dy = died.astype(jnp.int32)
        rank = jnp.cumsum(dy) - dy
        new_item = head + rank
        respawn = died & (new_item < total)
        head = head + jnp.sum(dy)
        item = jnp.where(died, new_item, item)

        o_new, d_new, st_new = spawn(new_item)
        rm = respawn[:, None]
        vs = (
            alive | respawn,
            jnp.where(respawn, True, new_ray),
            jnp.where(respawn, 0, bounce),
            jnp.where(respawn, 0.0, u_mode),
            jnp.where(respawn, 0.0, t_cur),
            jnp.where(respawn, 0.0, t_exit),
            jnp.where(rm, o_new, o),
            jnp.where(rm, d_new, d),
            jnp.where(respawn, st_new, st),
            jnp.where(rm, 1.0, beta),
            jnp.where(rm, 0.0, l_out),
        )
        return (vs, item, head), died, la, item_before, segment_starts

    return core0, step_round, n, total


def _static_vol_machine(
    scene, medium, samples, params, render_w, render_h, chunk_base, n_lanes,
    pix_offset, n_pix_total, row_map=None, with_log=True,
):
    """Static strided work assignment: lane i owns items {i, i+n, i+2n, ...}.

    The work-queue machine's per-round costs were DOMINATED by the queue
    itself: the radiance scatter (item-indexed, ~40 ns/row) and the jitter
    gather cost 1.9 ms of each 2.7 ms round at 32k lanes, while the eight
    fused flight steps cost 0.4 ms.  With a per-lane item slice both
    disappear: the finished radiance lands at the STATIC (local, lane)
    slot of a (items_per_lane, n, 3) log (elementwise one-hot add), and
    jitters come from a one-hot over the (small) items_per_lane axis of a
    pre-reshaped sample table.  The strided assignment decorrelates lanes
    (consecutive items = consecutive pixels spread across lanes), so by
    CLT the per-lane total step count concentrates: measured round counts
    run ~15-40% above the queue's, at ~3x lower per-round cost.

    Items keep their GLOBAL (pixel, sample) murmur RNG streams, so the
    per-item radiance is BIT-IDENTICAL to trace_balanced's — scheduling
    moves work between lanes, not decisions.

    Returns (core0, step_round, n, ipl, total) with step_round(core) ->
    (core', segment_starts, died, local_before, l_out_done); core =
    (vs, local, la_log).  With with_log=False the (ipl, n, 3) radiance
    log is dropped from the carry (a zero-size placeholder rides in its
    slot) — the differentiable replay must keep its per-round carry
    O(lanes), since jax.checkpoint stores the carry at every round
    boundary.
    """
    from .. import camera as camera_mod
    from .path import _next_pow2

    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if not n_lanes:
        n_lanes = 1 << max(
            14, int(np.ceil(np.log2(max(12.0 * float(total) ** 0.5, 1.0))))
        )
        n_lanes = min(n_lanes, 1 << 19, _next_pow2(total))
    n = n_lanes
    if n_pix_total is None:
        n_pix_total = n_pix
    ipl = -(-total // n)  # items per lane
    pad = ipl * n - total
    samples_ipl = jnp.concatenate(
        [samples.reshape(total, 2),
         jnp.zeros((pad, 2), samples.dtype)]
    ).reshape(ipl, n, 2)
    lane_idx = jnp.arange(n, dtype=jnp.int32)
    ipl_iota = jnp.arange(ipl, dtype=jnp.int32)

    def spawn(local):
        """(o, d, state, live) of each lane's item #local."""
        item = local * n + lane_idx
        live = item < total
        oh = (ipl_iota[:, None] == jnp.clip(local, 0, ipl - 1)[None, :])
        jit = jnp.einsum(
            "ln,lnc->nc", oh.astype(jnp.float32), samples_ipl,
            precision=jax.lax.Precision.HIGHEST,
        )
        it = jnp.clip(item, 0, total - 1)
        s = it // n_pix
        lp = it % n_pix
        if row_map is None:
            pix = lp + jnp.int32(pix_offset)
            px = pix % render_w
            py = pix // render_w
        else:
            px = lp % render_w
            py = row_map[lp // render_w]
            pix = py * render_w + px
        o, d = camera_mod.cast_rays(
            scene.cam_to_world, scene.fov, params.image_width,
            params.image_height, px, py, jit,
        )
        gid = (jnp.uint32(chunk_base) + s.astype(jnp.uint32)) * jnp.uint32(
            n_pix_total
        ) + pix.astype(jnp.uint32)
        return o, d, _path_stream_seed(gid), live

    local0 = jnp.zeros((n,), jnp.int32)
    o0, d0, st0, live0 = spawn(local0)
    vs0 = _vol_state(n, o0, d0, st0)
    vs0 = (live0,) + vs0[1:]
    la_log0 = (jnp.zeros((ipl, n, 3), jnp.float32) if with_log
               else jnp.zeros((0,), jnp.float32))
    core0 = (vs0, local0, la_log0)

    step, finish = _make_vol_step(scene, medium, params, n,
                                  defer_light=True)
    k_steps = int(_os.environ.get("NART_VOL_FUSE", "4"))

    def step_round(core):
        vs, local, la_log = core
        local_before = local
        died = jnp.zeros((n,), bool)
        esc_pend = jnp.zeros((n,), bool)
        segment_starts = jnp.zeros((), jnp.float32)
        for _ in range(k_steps):
            segment_starts = segment_starts + jnp.sum(
                (vs[0] & vs[1]).astype(jnp.float32)
            )
            vs, died_k, esc_k = step(vs)
            died = died | died_k
            esc_pend = esc_pend | esc_k
        vs = finish(vs, esc_pend)
        (alive, new_ray, bounce, u_mode, t_cur, t_exit, o, d, st, beta,
         l_out) = vs
        l_out_done = l_out

        if with_log:
            # fold finished radiance into the static (local, lane) slot
            oh = (
                (ipl_iota[:, None] == local[None, :]) & died[None, :]
            )
            la_log = la_log + jnp.where(oh[..., None], l_out[None], 0.0)

        # advance to the next owned item
        local_next = local + 1
        o_new, d_new, st_new, live_new = spawn(local_next)
        respawn = died & (local_next < ipl) & live_new
        local = jnp.where(died, local_next, local)
        rm = respawn[:, None]
        vs = (
            alive | respawn,
            jnp.where(respawn, True, new_ray),
            jnp.where(respawn, 0, bounce),
            jnp.where(respawn, 0.0, u_mode),
            jnp.where(respawn, 0.0, t_cur),
            jnp.where(respawn, 0.0, t_exit),
            jnp.where(rm, o_new, o),
            jnp.where(rm, d_new, d),
            jnp.where(respawn, st_new, st),
            jnp.where(rm, 1.0, beta),
            jnp.where(rm, 0.0, l_out),
        )
        return ((vs, local, la_log), segment_starts, died, local_before,
                l_out_done)

    return core0, step_round, n, ipl, total


def trace_vol_static(
    scene,
    bvh,
    samples,
    params,
    render_w,
    render_h,
    chunk_base=0,
    n_lanes=0,
    pix_offset=0,
    n_pix_total=None,
    row_map=None,
):
    """Static-assignment volume wavefront (same contract/results as
    trace_balanced; see _static_vol_machine for why it is faster)."""
    medium = scene.medium
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    if medium is None:
        return _no_medium_la(scene, samples, params, render_w, pix_offset)

    core0, step_round, n, ipl, total = _static_vol_machine(
        scene, medium, samples, params, render_w, render_h, chunk_base,
        n_lanes, pix_offset, n_pix_total, row_map=row_map,
    )

    def cond(carry):
        core, rays, rounds = carry
        return jnp.any(core[0][0]) & (rounds < _MAX_STEPS)

    def body(carry):
        core, rays, rounds = carry
        core, seg, _, _, _ = step_round(core)
        return core, rays + seg, rounds + 1

    core, rays, rounds = jax.lax.while_loop(
        cond, body, (core0, jnp.zeros((), jnp.float32),
                     jnp.zeros((), jnp.int32))
    )
    la_flat = core[2].reshape(ipl * n, 3)[:total]
    la4 = jnp.concatenate(
        [la_flat, jnp.ones((total, 1), jnp.float32)], axis=-1
    )
    return la4.reshape(spp_chunk, n_pix, 4), rays, rounds


def trace_vol_static_loss(
    scene,
    bvh,
    samples,
    cot,
    params,
    render_w,
    render_h,
    n_rounds,
    chunk_base=0,
    n_lanes=0,
    pix_offset=0,
    n_pix_total=None,
    row_map=None,
):
    """Differentiable static-assignment volume wavefront (the replay
    counterpart of trace_vol_static; same contract as
    trace_balanced_loss).  The cotangent table pre-reshapes to
    (items_per_lane, n, 4), so the per-round loss contribution is a
    one-hot product — no gathers inside the checkpointed round."""
    medium = scene.medium
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if medium is None:
        la, rays, _ = _no_medium_la(scene, samples, params, render_w,
                                    pix_offset)
        loss = jnp.sum(cot * la)
        return loss, rays, jnp.zeros((), jnp.int32)

    core0, step_round, n, ipl, total = _static_vol_machine(
        scene, medium, samples, params, render_w, render_h, chunk_base,
        n_lanes, pix_offset, n_pix_total, row_map=row_map, with_log=False,
    )
    pad = ipl * n - total
    cot_ipl = jnp.concatenate(
        [jnp.reshape(cot, (total, 4)), jnp.zeros((pad, 4), cot.dtype)]
    ).reshape(ipl, n, 4)
    ipl_iota = jnp.arange(ipl, dtype=jnp.int32)

    def round_body(core, loss, rays):
        core, seg, died, local_before, l_out = step_round(core)
        # one-hot select the finished item's cotangent row — no gather
        oh = (
            (ipl_iota[:, None] == local_before[None, :]) & died[None, :]
        ).astype(jnp.float32)
        c = jnp.einsum("ln,lnc->nc", oh, cot_ipl[..., :3],
                       precision=jax.lax.Precision.HIGHEST)
        contrib = jnp.sum(c * l_out, axis=-1) * died
        return core, loss + jnp.sum(contrib), rays + seg

    round_ckpt = jax.checkpoint(round_body)

    def body(i, carry):
        return round_ckpt(*carry)

    core, loss, rays = jax.lax.fori_loop(
        0, n_rounds, body,
        (core0, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
    )
    vs = core[0]
    # the constant-alpha (== 1) cotangent term carries no theta dependence
    done = (
        ipl_iota[:, None] * n + jnp.arange(n, dtype=jnp.int32)[None, :]
    ) < total
    loss = loss + jnp.sum(jnp.where(done, cot_ipl[..., 3], 0.0))
    unfinished = jnp.sum(vs[0].astype(jnp.int32))
    return loss, rays, unfinished


def trace_balanced(
    scene,
    bvh,
    samples,
    params,
    render_w,
    render_h,
    chunk_base=0,
    n_lanes=0,
    pix_offset=0,
    n_pix_total=None,
    row_map=None,
):
    """Work-queue volume wavefront (same contract as path.trace_balanced).

    Returns (la (spp_chunk, P, 4), rays, rounds).  Lanes are work slots:
    when a walk ends the lane pulls the next (pixel, sample) item via a
    prefix sum over this round's deaths.  Per-item RNG streams keyed by
    GLOBAL (pixel, sample) ids (chunk-size / lane-count / device-count
    invariant); the reference's per-pixel stream layout applies only to
    the lockstep mode, as with the path integrator.
    """
    medium = scene.medium
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    if medium is None:
        return _no_medium_la(scene, samples, params, render_w, pix_offset)

    core0, step_round, n, total = _balanced_vol_machine(
        scene, medium, samples, params, render_w, render_h, chunk_base,
        n_lanes, pix_offset, n_pix_total, row_map=row_map,
    )
    lane_idx = jnp.arange(n, dtype=jnp.int32)

    def cond(carry):
        core, la_out, rays, rounds = carry
        # iteration cap: a degenerate medium (NaN density, near-zero flight
        # steps) must fail fast instead of spinning the device loop
        return jnp.any(core[0][0]) & (rounds < _MAX_STEPS)

    def body(carry):
        core, la_out, rays, rounds = carry
        core, died, la, item, seg = step_round(core)
        # finished items write their radiance (alpha = 1, reference
        # parity).  Non-dying lanes scatter to distinct out-of-bounds
        # sentinels (total + lane) so the unique_indices promise holds.
        tgt = jnp.where(died, item, total + lane_idx)
        la_out = la_out.at[tgt].add(
            jnp.where(died[:, None], la, 0.0),
            mode="drop", unique_indices=True,
        )
        return core, la_out, rays + seg, rounds + 1

    carry = (
        core0,
        jnp.zeros((total, 3), jnp.float32),
        jnp.zeros((), jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    _, la_out, rays, rounds = jax.lax.while_loop(cond, body, carry)
    la4 = jnp.concatenate(  # alpha = 1 appended OUTSIDE the loop
        [la_out, jnp.ones((total, 1), jnp.float32)], axis=-1
    )
    return la4.reshape(spp_chunk, n_pix, 4), rays, rounds


def trace_balanced_loss(
    scene,
    bvh,
    samples,
    cot,
    params,
    render_w,
    render_h,
    n_rounds,
    chunk_base=0,
    n_lanes=0,
    pix_offset=0,
    n_pix_total=None,
    row_map=None,
):
    """Differentiable balanced volume wavefront: loss = sum(cot * la).

    The volume analog of path.trace_balanced_loss: the caller measures the
    round count with trace_balanced (cheap while_loop), then this replays
    the exact same rounds under a static fori_loop with jax.checkpoint on
    each round — decisions are deterministic per work item, and the event-
    probability ratio carriers (_ratio) route gradients to sigma_a/sigma_s/
    density/Le without touching forward values.  Accumulating the scalar
    cotangent-weighted radiance keeps the per-round carry O(lanes): full
    wavefront utilisation for the backward pass, unlike trace_diff's
    O(all-lanes x max-walk-length) lockstep.

    Returns (loss, rays, unfinished); unfinished > 0 means n_rounds was too
    small (rerun with more rounds).
    """
    medium = scene.medium
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if medium is None:
        la, rays, _ = _no_medium_la(scene, samples, params, render_w,
                                    pix_offset)
        loss = jnp.sum(cot * la)
        return loss, rays, jnp.zeros((), jnp.int32)

    core0, step_round, n, total = _balanced_vol_machine(
        scene, medium, samples, params, render_w, render_h, chunk_base,
        n_lanes, pix_offset, n_pix_total, row_map=row_map,
    )
    cot_flat = jnp.reshape(cot, (total, 4))

    def round_body(core, loss, rays):
        core, died, la, item, seg = step_round(core)
        c = cot_flat[jnp.clip(item, 0, total - 1)]
        # la is RGB; alpha is the constant 1, so its cotangent term is
        # c[..., 3] * 1 per finished item (no theta dependence)
        contrib = (jnp.sum(c[..., :3] * la, axis=-1) + c[..., 3]) * died
        return core, loss + jnp.sum(contrib), rays + seg

    round_ckpt = jax.checkpoint(round_body)

    def body(i, carry):
        return round_ckpt(*carry)

    core, loss, rays = jax.lax.fori_loop(
        0, n_rounds, body,
        (core0, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)),
    )
    unfinished = jnp.sum(core[0][0].astype(jnp.int32))
    return loss, rays, unfinished
