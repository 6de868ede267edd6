"""Wavefront path integrator with MIS, nested dielectrics, roughening, RR.

Parity: src/integrators/pathintegrator.cpp — restructured from a per-ray
recursive-style loop into a per-bounce SoA pipeline (SURVEY.md §7): every
bounce runs [light pass -> BVH intersect -> material resolve -> MIS direct
lighting (both strategies, one batched shadow traversal) -> scatter ->
nested-dielectric list update -> Russian roulette] on the whole wavefront
with masked lanes.

RNG discipline: each pixel lane owns one Xorshift32 state; draws happen at
the exact sites and in the exact order of the reference's scalar control
flow, advanced only on lanes whose branch would draw (rng.masked_next_*).
This keeps the sample-decision stream bit-identical to the reference
(SURVEY.md §3.3 note), which the scalar-oracle tests rely on.

Wavefront state lives in a Paths NamedTuple; the nested-dielectric
"intersection list" (pathintegrator.cpp:7-36, 123-142) is a fixed-size
per-lane table with insertion stamps (last/penultimate = max/2nd-max stamp,
erase = clear the newest matching slot).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.ad_checkpoint import checkpoint_name

from .. import bxdf, rng
from ..accel import BVH, intersect_bvh
from ..geometry import intersect_brute, pack_surface_rows, surface_at_packed
from ..lights import light_eval, light_sample
from ..materials import make_bsdf, mesh_luts
from ..select import row_pick, row_put, small_lut

SHADOW_BIAS = np.float32(0.001)  # pathintegrator.h:36
INF = np.float32(np.inf)
STACK_K = 8  # nested-dielectric stack slots per lane
# parking spot for culled rays: far outside any scene AABB, so the BVH
# slab test rejects them at the root
_FAR_POINT = np.asarray([1e8, 1e8, 1e8], np.float32)
_DEBUG_SKIP_SHADOW = False  # profiling only: treat all shadow rays unoccluded


# The per-lane nested-dielectric table is the largest piece of the bounce
# loop's while-carry, which round-trips HBM every iteration — so entries are
# bit-packed: one int32 = (stamp << 22) | (priority << 14) | mesh_id, 0 =
# empty (stamp starts at 1).  Limits (asserted at trace time via the scene):
# mesh_id < 2^14, priority < 2^8 (reference uint8), inserts/lane < 2^10.
_MESH_BITS = 14
_PRIO_BITS = 8
_MESH_MASK = (1 << _MESH_BITS) - 1
_PRIO_MASK = (1 << _PRIO_BITS) - 1


class IsectList(NamedTuple):
    packed: jnp.ndarray  # (N, K) int32, 0 = empty
    eta: jnp.ndarray  # (N, K) float32
    next_stamp: jnp.ndarray  # (N,) int32


def isect_list_init(n):
    return IsectList(
        packed=jnp.zeros((n, STACK_K), jnp.int32),
        eta=jnp.ones((n, STACK_K), jnp.float32),
        next_stamp=jnp.ones((n,), jnp.int32),
    )


def _unpack(packed):
    occupied = packed != 0
    stamp = packed >> (_MESH_BITS + _PRIO_BITS)
    prio = (packed >> _MESH_BITS) & _PRIO_MASK
    mesh = packed & _MESH_MASK
    return occupied, stamp, prio, mesh


def isect_list_query(lst: IsectList, mesh_id, priority):
    """IsectIsValid (pathintegrator.cpp:7-36): returns (valid, eta_outer)."""
    occupied, stamp, prio, mesh = _unpack(lst.packed)
    count = occupied.sum(axis=-1)
    # newest and second-newest entries (stamp == 0 for empty slots)
    last = jnp.argmax(stamp, axis=-1)
    stamp2 = row_put(stamp, last, 0)
    penult = jnp.argmax(stamp2, axis=-1)

    last_mesh = row_pick(mesh, last)
    last_eta = row_pick(lst.eta, last)
    penult_eta = row_pick(lst.eta, penult)

    eta_outer = jnp.where(
        count == 0,
        1.0,
        jnp.where(
            last_mesh != mesh_id,
            last_eta,
            jnp.where(count >= 2, penult_eta, 1.0),
        ),
    )
    valid = ~jnp.any(occupied & (priority[:, None] < prio), axis=-1)
    return valid, eta_outer


def isect_list_apply(lst: IsectList, mesh_id, priority, eta_sampled, do_update):
    """UpdateIsectList (pathintegrator.cpp:123-142), masked by do_update.

    Erase the newest slot matching mesh_id if present, else insert
    (mesh_id, priority, eta_sampled) into the first free slot.
    """
    occupied, stamp, _, mesh = _unpack(lst.packed)
    match = occupied & (mesh == mesh_id[:, None])
    has_match = jnp.any(match, axis=-1)

    match_stamp = jnp.where(match, stamp, -1)
    erase_slot = jnp.argmax(match_stamp, axis=-1)
    do_erase = do_update & has_match
    packed = row_put(lst.packed, erase_slot, 0, mask=do_erase)

    free = packed == 0
    ins_slot = jnp.argmax(free, axis=-1)
    do_insert = do_update & ~has_match & jnp.any(free, axis=-1)
    new_entry = (
        (lst.next_stamp << (_MESH_BITS + _PRIO_BITS))
        | (priority << _MESH_BITS)
        | mesh_id
    )
    packed = row_put(packed, ins_slot, new_entry, mask=do_insert)
    eta = row_put(lst.eta, ins_slot, eta_sampled, mask=do_insert)
    next_stamp = lst.next_stamp + do_insert.astype(jnp.int32)
    return IsectList(packed=packed, eta=eta, next_stamp=next_stamp)


class Paths(NamedTuple):
    """Wavefront state threaded through the bounce loop."""

    o: jnp.ndarray  # (N, 3) ray origin
    d: jnp.ndarray  # (N, 3) ray direction
    state: jnp.ndarray  # (N,) uint32 RNG
    beta: jnp.ndarray  # (N, 3) throughput
    l: jnp.ndarray  # (N, 3) radiance
    alpha: jnp.ndarray  # (N,)
    alive: jnp.ndarray  # (N,) bool
    flags: jnp.ndarray  # (N,) int32 running BSDF flags (carried, parity)
    eta_sampled: jnp.ndarray  # (N,)
    alpha_tweak: jnp.ndarray  # (N,)
    t_lim: jnp.ndarray  # (N,) carried isect.tMax
    rays: jnp.ndarray  # () float32 — rays traced (main + shadow), for stats
    lst: IsectList


def _flip_sign(z):
    return jnp.where(z > 0.0, np.float32(1.0), np.float32(-1.0))


def _nearest_light(lights, o, d, t_lim, part=None):
    """The per-bounce light pass (pathintegrator.cpp:167-182).

    Returns (le, t_light, light_hit) for the nearest light closer than
    t_lim.  Packed disk/ring lights evaluate in ONE (N, L) matmul batch
    with a single Le fetch for the argmin row (area_pack_nearest); only
    env/distant lights keep the per-light loop."""
    from ..lights import area_pack_nearest

    if part is None:
        part = _light_partition(lights)
    pack, rest, _ = part
    n = o.shape[0]
    le = jnp.zeros((n, 3))
    t_best = t_lim
    hit = jnp.zeros((n,), bool)
    if pack is not None:
        p_le, p_t, p_hit = area_pack_nearest(pack, o, d, t_lim)
        le = jnp.where(p_hit[:, None], p_le, le)
        t_best = jnp.where(p_hit, p_t, t_best)
        hit = hit | p_hit
    for j in rest:
        ev = light_eval(lights[j], o, d)
        closer = ev.t < t_best
        le = jnp.where(closer[:, None], ev.le, le)
        t_best = jnp.where(closer, ev.t, t_best)
        hit = hit | closer
    return le, t_best, hit


def _light_partition(lights):
    """(pack, rest_idx, row_of_light): packed area lights + the rest.

    row_of_light maps original light index -> pack row (or 0, unused)."""
    from ..lights import pack_area_lights

    pack, rest = pack_area_lights(lights)
    row = np.zeros(max(len(lights), 1), np.int32)
    if pack is not None:
        for r, i in enumerate(pack.index):
            row[i] = r
    return pack, rest, jnp.asarray(row)


def _index_in(index, members):
    """(N,) bool: index is one of the STATIC member ids (no gather)."""
    m = jnp.zeros(index.shape, bool)
    for i in members:
        m = m | (index == i)
    return m


def _select_light_eval(lights, index, p, wi, part=None):
    """Evaluate light[index] per lane.

    Constant-Le disk/ring lights evaluate ONCE on gathered packed
    parameters (O(N) regardless of the light count — the many-light
    path); env/distant/textured lights keep the per-light masked loop."""
    from ..lights import area_pack_eval

    if part is None:
        part = _light_partition(lights)
    pack, rest, row = part
    n = p.shape[0]
    le = jnp.zeros((n, 3))
    pdf = jnp.zeros((n,))
    t = jnp.full((n,), INF)
    if pack is not None:
        in_pack = _index_in(index, pack.index)
        lut = small_lut(index, len(lights))
        ev = area_pack_eval(pack, lut(row), p, wi)
        le = jnp.where(in_pack[:, None], ev.le, le)
        pdf = jnp.where(in_pack, ev.pdf, pdf)
        t = jnp.where(in_pack, ev.t, t)
    for j in rest:
        ev = light_eval(lights[j], p, wi)
        m = index == j
        le = jnp.where(m[:, None], ev.le, le)
        pdf = jnp.where(m, ev.pdf, pdf)
        t = jnp.where(m, ev.t, t)
    return le, pdf, t


def _select_light_sample(lights, index, p, u2, part=None):
    from ..lights import area_pack_sample

    if part is None:
        part = _light_partition(lights)
    pack, rest, row = part
    n = p.shape[0]
    le = jnp.zeros((n, 3))
    wi = jnp.zeros((n, 3))
    pdf = jnp.zeros((n,))
    t = jnp.full((n,), INF)
    if pack is not None:
        in_pack = _index_in(index, pack.index)
        lut = small_lut(index, len(lights))
        s_le, s_wi, s_pdf, s_t = area_pack_sample(pack, lut(row), p, u2)
        le = jnp.where(in_pack[:, None], s_le, le)
        wi = jnp.where(in_pack[:, None], s_wi, wi)
        pdf = jnp.where(in_pack, s_pdf, pdf)
        t = jnp.where(in_pack, s_t, t)
    for j in rest:
        s_le, s_wi, s_pdf, s_t, _ = light_sample(lights[j], p, u2)
        m = index == j
        le = jnp.where(m[:, None], s_le, le)
        wi = jnp.where(m[:, None], s_wi, wi)
        pdf = jnp.where(m, s_pdf, pdf)
        t = jnp.where(m, s_t, t)
    return le, wi, pdf, t


def _make_bounce(scene, bvh, params, n, differentiable=False):
    """Build the per-bounce wavefront step shared by every trace mode.

    Returns bounce_body(bounce, paths) -> Paths where `bounce` may be a
    scalar (all lanes in lockstep — the per-spp loop) or an (N,) int32
    vector (sample-regeneration mode: lanes at mixed depths).
    """
    n_lights = len(scene.lights)
    gamma = np.float32(params.roughening_factor**2)
    tri_v = jnp.asarray(scene.tri_v)
    tri_n = jnp.asarray(scene.tri_n)
    tri_uv = jnp.asarray(scene.tri_uv)
    tri_mesh = jnp.asarray(scene.tri_mesh)
    mesh_priority = jnp.asarray(scene.mesh_priority)
    # single-gather surface fetch (loop-invariant pack, see geometry.py)
    surf_rows = pack_surface_rows(tri_v, tri_n, tri_uv, tri_mesh)
    # packed area-light tables for the selected-light strategy (O(1) in
    # light count for constant-Le disk/ring lights)
    light_part = _light_partition(scene.lights)

    from ..accel import resolve_accel_kind

    accel_kind = resolve_accel_kind(getattr(params, "accel", "bvh"))
    # packed half textures on the non-differentiable path (exact parity:
    # the reference's in-memory textures are half); AD needs the f32 table
    tex_p2 = None
    if not differentiable and getattr(scene, "tex_slots", ()):
        from ..materials import pack_tex_half

        tex_p2 = pack_tex_half(jnp.asarray(scene.tex_data))
    if accel_kind == "pallas":
        from ..pallas_accel import intersect_pallas, occluded_pallas

        def isect(io, idd, tmin, tmax):
            return intersect_pallas(io, idd, tmin, tmax, bvh)

        def isect_occl(io, idd, tmin, tmax):
            # shadow rays only need a boolean: the any-hit walk retires a
            # lane at its first hit
            return occluded_pallas(io, idd, tmin, tmax, bvh)

    elif accel_kind == "brute":
        # chunked streaming intersector: every ray against every triangle
        def isect(io, idd, tmin, tmax):
            return intersect_brute(io, idd, tmin, tmax, tri_v, chunk=256)

        def isect_occl(io, idd, tmin, tmax):
            return isect(io, idd, tmin, tmax).valid

    else:

        def isect(io, idd, tmin, tmax):
            return intersect_bvh(io, idd, tmin, tmax, bvh)

        def isect_occl(io, idd, tmin, tmax):
            return isect(io, idd, tmin, tmax).valid

    def bounce_body(bounce, paths):
        p = paths
        # ---- light pass -------------------------------------------------
        le_cam, t_after_lights, light_hit = _nearest_light(
            scene.lights, p.o, p.d, p.t_lim, part=light_part
        )
        light_hit = light_hit & p.alive
        alpha = jnp.where(light_hit, 1.0, p.alpha)

        # ---- scene intersect -------------------------------------------
        # dead lanes are parked far outside the scene with t_max = 0 so the
        # BVH slab test culls them at the root
        o_main = jnp.where(p.alive[:, None], p.o, _FAR_POINT)
        hit = isect(
            o_main, p.d, jnp.zeros((n,)), jnp.where(p.alive, t_after_lights, 0.0)
        )
        if differentiable:
            # name the traversal outputs so the checkpoint policy saves them:
            # the backward replay then recomputes only the (cheap) shading
            # math, never the traversal while_loop — path-replay backprop
            # with stored hit records
            hit = jax.tree_util.tree_map(
                lambda x: checkpoint_name(x, "isect"), hit
            )
        hit_valid = hit.valid & p.alive
        surf = surface_at_packed(hit, surf_rows)

        # miss handling (pathintegrator.cpp:252-257):
        #   bounce 0 + lightHit: L = Le; any miss: lane dead
        miss = p.alive & ~hit.valid
        l_out = jnp.where(
            (miss & (bounce == 0) & light_hit)[:, None], le_cam, p.l
        )
        alive = p.alive & hit.valid

        # ---- material resolve ------------------------------------------
        frame, desc = make_bsdf(
            scene, surf.mesh, surf.st, surf.sn, surf.dpds, p.alpha_tweak,
            tex_p2=tex_p2,
        )
        prio = mesh_luts(surf.mesh, mesh_priority.shape[0])[2](mesh_priority)
        valid, eta_outer = isect_list_query(p.lst, surf.mesh, prio)
        m_valid = alive & valid
        m_invalid = alive & ~valid
        alpha = jnp.where(m_valid & (bounce == 0), 1.0, alpha)

        wo = bxdf.to_local(frame, -p.d)

        # ================= EstimateDirect (pathintegrator.cpp:38-121) ====
        # draw site 1: light pick
        u_pick, st8 = rng.masked_next_float(p.state, m_valid)
        light_idx = (
            jnp.minimum(u_pick, np.float32(1.0) - np.float32(1.1920929e-07))
            * np.float32(n_lights)
        ).astype(jnp.int32)
        # draw sites 2-4: strategy A scatter sample + lobe pick
        ua_x, st8 = rng.masked_next_float(st8, m_valid)
        ua_y, st8 = rng.masked_next_float(st8, m_valid)
        ua_l, st8 = rng.masked_next_float(st8, m_valid)
        dir_flags0 = jnp.zeros((n,), jnp.int32)
        fA, wiA, pdfA, dflags, _, _ = bxdf.bsdf_sample_f(
            desc,
            wo,
            ua_l,
            jnp.stack([ua_x, ua_y], -1),
            jnp.ones((n,), bool),
            eta_outer,
            dir_flags0,
        )
        wiA = jax.lax.stop_gradient(wiA)
        pdfA = jax.lax.stop_gradient(pdfA)
        wiA_world = jax.lax.stop_gradient(bxdf.to_world(frame, wiA))
        liA, light_pdf_A, tA = _select_light_eval(
            scene.lights, light_idx, surf.p, wiA_world, part=light_part
        )
        light_pdf_A = jax.lax.stop_gradient(light_pdf_A)
        # draw sites 5-6: strategy B light sample
        ub_x, st8 = rng.masked_next_float(st8, m_valid)
        ub_y, st8 = rng.masked_next_float(st8, m_valid)
        liB, wiB_world, light_pdf_B, tB = _select_light_sample(
            scene.lights, light_idx, surf.p, jnp.stack([ub_x, ub_y], -1),
            part=light_part,
        )
        wiB_world = jax.lax.stop_gradient(wiB_world)
        light_pdf_B = jax.lax.stop_gradient(light_pdf_B)
        wiB = jax.lax.stop_gradient(bxdf.to_local(frame, wiB_world))
        # strategy B's bsdf terms don't depend on occlusion: evaluate them
        # BEFORE the shadow traversal so provably-zero lanes (f == 0 and
        # pdf == 0 — every delta lobe) never trace.  The reference traces
        # first and gets 0 via f (pathintegrator.cpp:92-118); culling is
        # exact and halves shadow work on specular-heavy scenes.
        pdfB = jax.lax.stop_gradient(
            bxdf.bsdf_pdf(desc, wo, wiB, jnp.ones((n,), bool), eta_outer)
        )
        fB = bxdf.bsdf_f(desc, wo, wiB, jnp.ones((n,), bool), eta_outer)

        # one batched shadow traversal for both strategies.  Lanes whose
        # result cannot contribute (invalid hit, zero bsdf pdf, or a missed /
        # black light) are culled: parked at _FAR_POINT with t_max = 0 so
        # their walk ends at the root.
        useA = (
            m_valid
            & (pdfA > 0.0)
            & ((light_pdf_A > 0.0) | jnp.any(liA > 0.0, axis=-1))
        )
        useB = (
            m_valid
            & (light_pdf_B > 0.0)
            & ((pdfB > 0.0) | jnp.any(fB > 0.0, axis=-1))
        )
        oA = surf.p + surf.gn * (SHADOW_BIAS * _flip_sign(wiA[..., 2]))[:, None]
        oB = surf.p + surf.gn * (SHADOW_BIAS * _flip_sign(wiB[..., 2]))[:, None]
        sh_o = jnp.concatenate(
            [
                jnp.where(useA[:, None], oA, _FAR_POINT),
                jnp.where(useB[:, None], oB, _FAR_POINT),
            ],
            axis=0,
        )
        sh_d = jnp.concatenate([wiA_world, wiB_world], axis=0)
        sh_t = jnp.concatenate(
            [jnp.where(useA, tA, 0.0), jnp.where(useB, tB, 0.0)], axis=0
        )
        if _DEBUG_SKIP_SHADOW:  # profiling knob: attribute traversal cost
            occ = jnp.zeros((2 * n,), bool)
        else:
            occ = isect_occl(sh_o, sh_d, jnp.zeros((2 * n,)), sh_t)
            if differentiable:
                occ = checkpoint_name(occ, "isect")
        occA = occ[:n]
        occB = occ[n : 2 * n]

        # strategy A contribution (BSDF sampling)
        wA_spec = (dflags & bxdf.SPECULAR) != 0
        misA = (pdfA * pdfA) / jnp.maximum(
            pdfA * pdfA + light_pdf_A * light_pdf_A, 1e-30
        )
        weightA = jnp.where(wA_spec, 1.0, misA)
        addA = (
            m_valid
            & (pdfA > 0.0)
            & ~occA
            & (wA_spec | (light_pdf_A > 0.0))
        )
        if not getattr(params, "mis_bsdf", True):
            addA = addA & False
        if not getattr(params, "mis_light", True):
            # single-strategy weight = 1 (reference #if toggles drop the
            # power-heuristic denominator term)
            weightA = jnp.ones_like(weightA)
        contribA = (
            fA
            * liA
            * (jnp.abs(wiA[..., 2]) * weightA / jnp.where(pdfA > 0, pdfA, 1.0))[
                :, None
            ]
        )
        l_direct = jnp.where(addA[:, None], contribA, 0.0)

        # strategy B contribution (light sampling; fB/pdfB hoisted above)
        misB = (light_pdf_B * light_pdf_B) / jnp.maximum(
            pdfB * pdfB + light_pdf_B * light_pdf_B, 1e-30
        )
        addB = m_valid & ~occB & (light_pdf_B > 0.0) & (pdfB > 0.0)
        if not getattr(params, "mis_light", True):
            addB = addB & False
        if not getattr(params, "mis_bsdf", True):
            misB = jnp.ones_like(misB)
        contribB = (
            fB
            * liB
            * (
                jnp.abs(wiB[..., 2])
                * misB
                / jnp.where(light_pdf_B > 0, light_pdf_B, 1.0)
            )[:, None]
        )
        l_direct = l_direct + jnp.where(addB[:, None], contribB, 0.0)
        l_out = l_out + jnp.where(
            m_valid[:, None], l_direct * np.float32(n_lights) * p.beta, 0.0
        )

        # ================= scatter (pathintegrator.cpp:199-220) ==========
        us_x, st8 = rng.masked_next_float(st8, m_valid)
        us_y, st8 = rng.masked_next_float(st8, m_valid)
        us_l, st8 = rng.masked_next_float(st8, m_valid)
        fS, wiS, pdfS, new_flags, alpha_i, eta_smp = bxdf.bsdf_sample_f(
            desc,
            wo,
            us_l,
            jnp.stack([us_x, us_y], -1),
            jnp.zeros((n,), bool),
            eta_outer,
            p.flags,
        )
        wiS = jax.lax.stop_gradient(wiS)
        pdfS_det = jax.lax.stop_gradient(pdfS)
        pdf_ok = pdfS > 0.0
        alpha_tweak = jnp.where(
            m_valid & pdf_ok,
            (1.0 - gamma * alpha_i) * p.alpha_tweak,
            p.alpha_tweak,
        )
        beta = jnp.where(
            (m_valid & pdf_ok)[:, None],
            p.beta
            * fS
            * (jnp.abs(wiS[..., 2]) / jnp.where(pdf_ok, pdfS_det, 1.0))[:, None],
            p.beta,
        )
        wiS_world = jax.lax.stop_gradient(bxdf.to_world(frame, wiS))
        new_o = jnp.where(
            (m_valid & pdf_ok)[:, None],
            surf.p
            + surf.gn * (SHADOW_BIAS * _flip_sign(wiS[..., 2]))[:, None],
            p.o,
        )
        new_d = jnp.where((m_valid & pdf_ok)[:, None], wiS_world, p.d)
        flags = jnp.where(m_valid, new_flags, p.flags)
        eta_sampled = jnp.where(m_valid, eta_smp, p.eta_sampled)

        # invalid (priority-skipped) branch (pathintegrator.cpp:223-229)
        u_eta, st8 = rng.masked_next_float(st8, m_invalid)
        eta_inv = bxdf.bsdf_sample_eta(desc, u_eta)
        new_o = jnp.where(
            m_invalid[:, None], surf.p + p.d * SHADOW_BIAS, new_o
        )
        new_d = jnp.where(m_invalid[:, None], p.d, new_d)
        flags = jnp.where(m_invalid, bxdf.TRANSMISSIVE, flags)
        eta_sampled = jnp.where(m_invalid, eta_inv, eta_sampled)

        # lanes breaking on pdf<=0 exit before the list update and RR
        # (pathintegrator.cpp:214)
        no_break = jnp.where(m_valid, pdf_ok, True)

        # transmissive: update the nested-dielectric list
        do_update = alive & no_break & ((flags & bxdf.TRANSMISSIVE) != 0)
        lst = isect_list_apply(p.lst, surf.mesh, prio, eta_sampled, do_update)

        # Russian roulette (pathintegrator.cpp:237-246): only lanes that hit
        # and did not break on pdf<=0 reach it, and only for bounce > 3
        survived_scatter = no_break
        rr_mask = alive & survived_scatter & (bounce > 3)
        u_rr, st8 = rng.masked_next_float(st8, rr_mask)
        q = jnp.maximum(jnp.sum(beta, -1) * np.float32(0.33333), 0.0)
        rr_live = q >= u_rr
        q_det = jax.lax.stop_gradient(q)  # RR is a sampling decision
        beta = jnp.where(
            (rr_mask & rr_live)[:, None],
            beta / jnp.where(q_det > 0, q_det, 1.0)[:, None],
            beta,
        )
        alive = alive & survived_scatter & ~(rr_mask & ~rr_live)

        return Paths(
            o=new_o,
            d=new_d,
            state=st8,
            beta=beta,
            l=l_out,
            alpha=alpha,
            alive=alive,
            flags=flags,
            eta_sampled=eta_sampled,
            alpha_tweak=alpha_tweak,
            t_lim=jnp.where(alive, INF, p.t_lim),  # isect reset on live lanes
            # algorithmic ray count (reference-equivalent denominator for
            # Mrays/s): one camera/bounce ray per live lane + the two
            # EstimateDirect shadow rays per valid hit, whether the shadow
            # query was traced or resolved analytically (useA/useB culls
            # only provably-zero lanes the reference traces physically)
            rays=p.rays
            + jnp.sum(p.alive.astype(jnp.float32))
            + 2.0 * jnp.sum(m_valid.astype(jnp.float32)),
            lst=lst,
        )

    return bounce_body


def _paths_init(n, o, d, state):
    return Paths(
        o=o,
        d=d,
        state=state,
        beta=jnp.ones((n, 3)),
        l=jnp.zeros((n, 3)),
        alpha=jnp.zeros((n,)),
        alive=jnp.ones((n,), bool),
        flags=jnp.zeros((n,), jnp.int32),
        eta_sampled=jnp.ones((n,)),
        alpha_tweak=jnp.ones((n,)),
        t_lim=jnp.full((n,), INF),
        rays=jnp.zeros((), jnp.float32),
        lst=isect_list_init(n),
    )


def trace(scene, bvh: BVH, o, d, state, params, differentiable=False):
    """Trace one wavefront of camera rays to radiance.

    Args:
      scene: SceneData (leaves jnp-convertible).
      bvh: built BVH over the scene triangle soup.
      o, d: (N, 3) camera rays.
      state: (N,) uint32 RNG states (already past the Latin-square draws).
      differentiable: use a static-trip-count rematerialised bounce loop so
        reverse-mode AD works (path-replay backprop: every sampling decision
        is detached; the backward pass recomputes each bounce instead of
        storing it — jax.checkpoint on the bounce body).
    Returns (L (N,3), alpha (N,), state, rays_traced ()).
    """
    n = o.shape[0]
    bounce_body = _make_bounce(scene, bvh, params, n, differentiable)
    paths = _paths_init(n, o, d, state)

    if differentiable:
        # Reverse-mode needs a static trip count; per-bounce jax.checkpoint
        # keeps memory at O(wavefront).  The policy stores the traversal
        # outputs (named "isect") as residuals, so the backward replay only
        # redoes shading.  lax.cond skips entire bounces (fwd AND replay)
        # once every lane is dead — the differentiable analog of the
        # while_loop early exit below.
        body_ckpt = jax.checkpoint(
            bounce_body,
            policy=jax.checkpoint_policies.save_only_these_names("isect"),
        )

        def diff_bounce(b, p):
            return jax.lax.cond(
                jnp.any(p.alive),
                lambda p: body_ckpt(jnp.int32(b), p),
                lambda p: p,
                p,
            )

        paths = jax.lax.fori_loop(0, params.bounces, diff_bounce, paths)
    else:

        def cond(carry):
            bounce, paths = carry
            return (bounce < params.bounces) & jnp.any(paths.alive)

        def body(carry):
            bounce, paths = carry
            return bounce + 1, bounce_body(bounce, paths)

        _, paths = jax.lax.while_loop(cond, body, (jnp.int32(0), paths))
    return paths.l, paths.alpha, paths.state, paths.rays


def _isect_list_reset(lst: IsectList, mask):
    m = mask[:, None]
    return IsectList(
        packed=jnp.where(m, 0, lst.packed),
        eta=jnp.where(m, 1.0, lst.eta),
        next_stamp=jnp.where(mask, 1, lst.next_stamp),
    )


def trace_regen(scene, bvh, px, py, samples, state, params):
    """Sample-regeneration wavefront: all spp of every pixel in ONE loop.

    The per-spp lockstep loop (trace() called once per sample) wastes whole
    rounds once most lanes are dead — per-round cost is nearly constant in
    the live-lane count, and glass/caustic tails keep a few lanes alive to
    the bounce cap.  Here each lane owns one pixel and processes its spp
    samples BACK TO BACK: the moment sample s dies (miss / pdf<=0 / RR /
    bounce cap — pathintegrator.cpp:166's loop exit conditions), its
    radiance is folded into a per-lane filter-tap window accumulator and the
    lane respawns with sample s+1's camera ray in the same round.  Lanes
    stay ~fully utilised until the whole chunk drains: round count drops
    from spp * bounces to ~spp * mean_path_length + tail.

    RNG parity: lane i's draws happen in exactly the per-pixel order of the
    sequential renderer (Latin-square first — `samples` is drawn by the
    caller — then every sample's path draws back to back), so sampling
    decisions are bit-identical to trace() / the scalar oracle.

    The loop body only writes the finished sample's radiance into a per-
    (lane, sample) slot (a one-hot select); ALL filter-tap math happens
    after the loop (the tap_weights floor/sqrt/table chain inside a while
    body made compiles take minutes).

    Args:
      px, py: (N,) lane pixel coords (row-major full grid).
      samples: (spp_chunk, N, 2) Latin-square jitters for this chunk.
      state: (N,) uint32 RNG states (past the Latin-square draws).
    Returns (la (spp_chunk, N, 4) per-sample RGBA radiance, state, rays).
    The caller splats la[s] in sample order (film.splat_grid), which keeps
    the film BIT-identical to the sequential per-spp loop and independent
    of the chunk size (checkpoint/resume exactness).
    """
    from .. import camera as camera_mod

    n = px.shape[0]
    spp_chunk = samples.shape[0]
    bounce_body = _make_bounce(scene, bvh, params, n)

    def cast(jitter):
        return camera_mod.cast_rays(
            scene.cam_to_world,
            scene.fov,
            params.image_width,
            params.image_height,
            px,
            py,
            jitter,
        )

    o0, d0 = cast(samples[0])
    carry0 = (
        _paths_init(n, o0, d0, state),
        jnp.zeros((n,), jnp.int32),  # per-lane bounce
        jnp.zeros((n,), jnp.int32),  # per-lane sample index
        jnp.zeros((spp_chunk, n, 4), jnp.float32),  # per-sample radiance
    )

    def cond(carry):
        paths = carry[0]
        return jnp.any(paths.alive)

    def body(carry):
        paths, bounce, samp, la_out = carry
        was_alive = paths.alive
        p = bounce_body(bounce, paths)

        # loop-exit bookkeeping: the reference's `for bounce < bounces`
        # ends a sample after its params.bounces'th iteration
        bounce_next = jnp.where(was_alive, bounce + 1, bounce)
        exhausted = p.alive & (bounce_next >= params.bounces)
        alive = p.alive & ~exhausted
        dying = was_alive & ~alive

        # record the finished sample's radiance in its slot
        la = jnp.concatenate([p.l, p.alpha[:, None]], axis=-1)
        slot = (
            jnp.arange(spp_chunk, dtype=jnp.int32)[:, None] == samp[None, :]
        )
        la_out = la_out + jnp.where(
            (slot & dying[None, :])[..., None], la[None], 0.0
        )

        # respawn with the pixel's next sample (same RNG stream — parity
        # with the sequential per-spp loop)
        samp_next = samp + 1
        respawn = dying & (samp_next < spp_chunk)
        samp = jnp.where(dying, samp_next, samp)
        # per-lane jitter fetch: one-hot over the (small, static) chunk axis
        onehot = (
            jnp.arange(spp_chunk, dtype=jnp.int32)[:, None]
            == jnp.clip(samp_next, 0, spp_chunk - 1)[None, :]
        )
        jitter_new = jnp.einsum(
            "sn,snc->nc", onehot.astype(jnp.float32), samples,
            precision=jax.lax.Precision.HIGHEST,
        )
        o_new, d_new = cast(jitter_new)
        rm = respawn[:, None]
        paths = Paths(
            o=jnp.where(rm, o_new, p.o),
            d=jnp.where(rm, d_new, p.d),
            state=p.state,
            beta=jnp.where(rm, 1.0, p.beta),
            l=jnp.where(rm, 0.0, p.l),
            alpha=jnp.where(respawn, 0.0, p.alpha),
            alive=alive | respawn,
            flags=jnp.where(respawn, 0, p.flags),
            eta_sampled=jnp.where(respawn, 1.0, p.eta_sampled),
            alpha_tweak=jnp.where(respawn, 1.0, p.alpha_tweak),
            t_lim=jnp.where(respawn, INF, p.t_lim),
            rays=p.rays,
            lst=_isect_list_reset(p.lst, respawn),
        )
        bounce = jnp.where(respawn, 0, bounce_next)
        return paths, bounce, samp, la_out

    paths, _, _, la_out = jax.lax.while_loop(cond, body, carry0)
    return la_out, paths.state, paths.rays


def _next_pow2(v):
    return 1 << int(np.ceil(np.log2(max(int(v), 1))))


def _path_stream_seed(item):
    """Independent RNG stream per (pixel, sample) work item.

    murmur3 finalizer on the global item id, then the reference's seeding
    offset (rng.seed).  Used by the balanced wavefront, where a lane is a
    work SLOT rather than a pixel, so per-pixel sequential streams (the
    reference's layout, kept bit-exact by wavefront="spp"/"regen") cannot
    apply.  Deterministic and collision-free by construction; statistical
    equivalence vs the reference layout is covered by the golden tests.
    """
    h = item.astype(jnp.uint32)
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return rng.seed(h)


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
    """Work-queue wavefront: lanes pull (pixel, sample) items on death.

    trace_regen fixes the per-SAMPLE dead-lane waste but still binds each
    lane to one pixel — and path length is spatially systematic (every
    sample of a glass-sphere pixel runs to the bounce cap), so the slowest
    pixel still sets the round count.  Here the (pixel, sample) pairs of
    the chunk form one global queue in pixel-major order (consecutive
    respawns get consecutive pixels of the same sample index — coherent
    camera rays); the moment a lane's path terminates it pulls the next
    item via a prefix-sum over this round's dying lanes.  Round count
    drops to ceil(total_items * mean_path_length / n_lanes) + max path
    length, independent of WHERE the long paths live.  n_lanes is a free
    parameter (not tied to the pixel count): more lanes = fewer rounds =
    less per-round launch overhead per ray.

    RNG: each item gets an independent stream (_path_stream_seed of its
    GLOBAL sample id — chunk_base * n_pixels + local item), so results are
    deterministic and chunk-size invariant, but the per-pixel stream
    layout of the reference does NOT apply (use wavefront="spp"/"regen"
    for bit-exact stream parity; image-sample jitters still come from the
    reference's per-pixel Latin-square draws either way).

    Args:
      samples: (spp_chunk, P, 2) per-pixel Latin-square jitters.
      render_w, render_h: static lane-grid dims (P = render_w * render_h).
      chunk_base: first GLOBAL sample index of this chunk (spp offset).
      n_lanes: work slots; 0 = auto (min(total_items, 2^20)).
    Returns (la (spp_chunk, P, 4) per-sample RGBA radiance, rays, rounds).
    """
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    core0, step = _balanced_machine(
        scene, bvh, samples, params, render_w, render_h, chunk_base, n_lanes,
        pix_offset=pix_offset, n_pix_total=n_pix_total, row_map=row_map,
    )

    carry0 = (
        core0,
        jnp.zeros((total, 4), jnp.float32),  # per-item radiance
        jnp.zeros((), jnp.int32),  # rounds executed
    )

    def cond(carry):
        return jnp.any(carry[0][0].alive)

    def body(carry):
        core, la_out, rounds = carry
        core, dying, la, item = step(core)
        # finished items write their radiance; non-dying lanes scatter to
        # DISTINCT out-of-bounds sentinels (total + lane) so the
        # unique_indices promise holds unconditionally
        tgt = jnp.where(dying, item, total + jnp.arange(dying.shape[0]))
        la_out = la_out.at[tgt].add(
            jnp.where(dying[:, None], la, 0.0),
            mode="drop",
            unique_indices=True,
        )
        return core, la_out, rounds + 1

    (paths, *_), la_out, rounds = jax.lax.while_loop(cond, body, carry0)
    return la_out.reshape(spp_chunk, n_pix, 4), paths.rays, rounds


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
    """Differentiable balanced wavefront: scalar loss = sum(cot * la).

    The reverse-mode counterpart of trace_balanced for path-replay
    backprop at full wavefront utilisation.  Reverse AD needs a static
    trip count, so the caller first runs trace_balanced (cheap, while_loop)
    and passes its measured round count — the fori_loop here replays the
    exact same rounds (decisions are deterministic per work item).  Each
    round is jax.checkpoint'ed storing only the traversal outputs
    ("isect"): the backward pass replays the shading math per round and
    never re-runs the intersection kernels.

    Accumulating a SCALAR (the cotangent-weighted radiance sum) instead of
    the (total_items, 4) radiance table keeps the per-round carry O(lanes):
    for an arbitrary image loss, linearise first (compute d loss / d la
    from the forward image — the splat is linear in la) and pass it as
    `cot`.

    Args:
      cot: (spp_chunk, P, 4) cotangent of the per-sample radiance.
      n_rounds: static round count (>= the forward pass's measured count;
        extra rounds are no-ops).
    Returns (loss, rays, unfinished) — unfinished > 0 means n_rounds was
    too small (result invalid; rerun with more rounds).
    """
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    core0, step = _balanced_machine(
        scene,
        bvh,
        samples,
        params,
        render_w,
        render_h,
        chunk_base,
        n_lanes,
        differentiable=True,
        pix_offset=pix_offset,
        n_pix_total=n_pix_total,
        row_map=row_map,
    )
    cot_flat = jnp.reshape(cot, (total, 4))

    def round_body(core, loss):
        core, dying, la, item = step(core)
        c = cot_flat[jnp.clip(item, 0, total - 1)]
        contrib = jnp.sum(c * la, axis=-1) * dying.astype(jnp.float32)
        return core, loss + jnp.sum(contrib)

    round_ckpt = jax.checkpoint(
        round_body,
        policy=jax.checkpoint_policies.save_only_these_names("isect"),
    )

    def body(i, carry):
        core, loss = carry
        return round_ckpt(core, loss)

    core, loss = jax.lax.fori_loop(
        0, n_rounds, body, (core0, jnp.zeros((), jnp.float32))
    )
    paths = core[0]
    unfinished = jnp.sum(paths.alive.astype(jnp.int32))
    return loss, paths.rays, unfinished


def _balanced_machine(
    scene,
    bvh,
    samples,
    params,
    render_w,
    render_h,
    chunk_base,
    n_lanes,
    differentiable=False,
    pix_offset=0,
    n_pix_total=None,
    row_map=None,
):
    """Shared work-queue machinery for the balanced wavefront.

    pix_offset/n_pix_total support sharding: local items cover n_pix
    pixels starting at global pixel id pix_offset of a n_pix_total grid;
    RNG stream seeds use GLOBAL (pixel, sample) ids so the result is
    invariant to the device count / slab decomposition.  row_map
    ((local_rows,) int32, optional) generalises the contiguous slab to an
    arbitrary row assignment (striped sharding): local row r is global
    image row row_map[r], and pix_offset is ignored.

    Returns (core0, step): step(core) -> (core', dying, la, item_before)
    where `la` is the RGBA radiance of lanes whose item finished this
    round (`dying`), and `item_before` identifies that item.
    """
    from .. import camera as camera_mod

    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if not n_lanes:
        # Lane-count tradeoff: per-round cost grows ~linearly with lanes
        # while queue rounds shrink as work/lanes — but the DRAIN tail
        # (max path length rounds while the queue empties) always costs
        # ~bounces full-price rounds, so oversized wavefronts pay bounces *
        # c(lanes) of mostly-idle work.  Minimising (work/L + bounces) *
        # c(L) gives L* ~ sqrt(work).  The 12x factor and the 64k floor
        # were fitted on another accelerator and are unmeasured on this
        # one.
        target = 12.0 * float(total) ** 0.5
        n_lanes = 1 << max(16, int(np.ceil(np.log2(max(target, 1.0)))))
        n_lanes = min(n_lanes, 1 << 19, _next_pow2(total))
    n = n_lanes
    if n_pix_total is None:
        n_pix_total = n_pix
    bounce_body = _make_bounce(scene, bvh, params, n, differentiable)
    samples_flat = samples.reshape(total, 2)

    def spawn(item):
        """Item -> (o, d, state) for its (pixel, sample)."""
        it = jnp.clip(item, 0, total - 1)
        jit = samples_flat[it]
        s = it // n_pix
        lp = it % n_pix  # local pixel index
        if row_map is None:
            pix = lp + jnp.int32(pix_offset)  # global pixel id
            px = pix % render_w
            py = pix // render_w
        else:
            px = lp % render_w
            py = row_map[lp // render_w]
            pix = py * render_w + px
        o, d = camera_mod.cast_rays(
            scene.cam_to_world,
            scene.fov,
            params.image_width,
            params.image_height,
            px,
            py,
            jit,
        )
        gid = (jnp.uint32(chunk_base) + s.astype(jnp.uint32)) * jnp.uint32(
            n_pix_total
        ) + pix.astype(jnp.uint32)
        state = _path_stream_seed(gid)
        return o, d, state

    item0 = jnp.arange(n, dtype=jnp.int32)
    o0, d0, st0 = spawn(item0)
    paths0 = _paths_init(n, o0, d0, st0)
    paths0 = paths0._replace(alive=item0 < total)
    core0 = (
        paths0,
        jnp.zeros((n,), jnp.int32),  # per-lane bounce
        item0,  # per-lane work item
        jnp.int32(min(n, total)),  # queue head
        jnp.int32(0),  # round counter
    )

    def step(core):
        paths, bounce, item, head, round_no = core
        was_alive = paths.alive
        p = bounce_body(bounce, paths)

        bounce_next = jnp.where(was_alive, bounce + 1, bounce)
        exhausted = p.alive & (bounce_next >= params.bounces)
        alive = p.alive & ~exhausted
        dying = was_alive & ~alive
        la = jnp.concatenate([p.l, p.alpha[:, None]], axis=-1)
        item_before = item

        # pull the next queue items (prefix sum over this round's deaths)
        dy = dying.astype(jnp.int32)
        rank = jnp.cumsum(dy) - dy
        new_item = head + rank
        respawn = dying & (new_item < total)
        head = head + jnp.sum(dy)
        item = jnp.where(dying, new_item, item)

        o_new, d_new, st_new = spawn(new_item)
        rm = respawn[:, None]
        paths = Paths(
            o=jnp.where(rm, o_new, p.o),
            d=jnp.where(rm, d_new, p.d),
            state=jnp.where(respawn, st_new, p.state),
            beta=jnp.where(rm, 1.0, p.beta),
            l=jnp.where(rm, 0.0, p.l),
            alpha=jnp.where(respawn, 0.0, p.alpha),
            alive=alive | respawn,
            flags=jnp.where(respawn, 0, p.flags),
            eta_sampled=jnp.where(respawn, 1.0, p.eta_sampled),
            alpha_tweak=jnp.where(respawn, 1.0, p.alpha_tweak),
            t_lim=jnp.where(respawn, INF, p.t_lim),
            rays=p.rays,
            lst=_isect_list_reset(p.lst, respawn),
        )
        bounce = jnp.where(respawn, 0, bounce_next)

        return (paths, bounce, item, head, round_no + 1), dying, la, item_before

    return core0, step
