"""Scalar oracle: a straight transcription of the reference's per-ray
control flow (src/integrators/pathintegrator.cpp, src/core/render.cpp) in
plain Python, one ray at a time.

Purpose: validate the wavefront integrator's *mechanics* — masked RNG draw
order, MIS accumulation, nested-dielectric list semantics, Russian roulette,
bounce/termination handling — against an implementation whose control flow
is line-for-line the reference's.  Lobe/light math reuses the vectorised
modules with batch size 1 (their own correctness is covered by dedicated
unit tests), so any disagreement isolates a wavefront-orchestration bug.

Slow by construction; use tiny scenes only.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from nart_jax import bxdf, camera, film, geometry, rng
from nart_jax.lights import light_eval, light_sample
from nart_jax.materials import make_bsdf

SHADOW_BIAS = np.float32(0.001)
FLT_BEFORE_ONE = np.float32(1.0) - np.float32(1.1920928955078125e-07)


def _b1(x):
    return jnp.asarray(np.asarray(x, np.float32)[None])


def _intersect(scene, o, d, t_max):
    hit = geometry.intersect_brute(
        _b1(o).reshape(1, 3),
        _b1(d).reshape(1, 3),
        jnp.zeros(1),
        jnp.full(1, np.float32(t_max)),
        jnp.asarray(scene.tri_v),
    )
    return hit


def _occluded(scene, o, d, t_max):
    hit = _intersect(scene, o, d, t_max)
    return bool(hit.valid[0])


def li_alpha(scalar_rng, o, d, scene, params):
    """PathIntegrator::Li_alpha transcription (pathintegrator.cpp:144-260)."""
    isect_list = []  # list of (mesh, priority, eta) — append/erase like ref
    l_out = np.zeros(3, np.float32)
    alpha = np.float32(0.0)
    eta_sampled = np.float32(1.0)
    beta = np.ones(3, np.float32)
    flags = 0
    gamma = np.float32(params.roughening_factor) ** 2
    alpha_tweak = np.float32(1.0)
    t_lim = np.float32(np.inf)
    n_lights = len(scene.lights)

    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)

    for bounce in range(params.bounces):
        # light pass
        light_t_max = t_lim
        light_hit = False
        le = np.zeros(3, np.float32)
        for li in scene.lights:
            ev = light_eval(li, _b1(o).reshape(1, 3), _b1(d).reshape(1, 3))
            t_j = float(ev.t[0])
            if t_j < light_t_max:
                le = np.asarray(ev.le[0])
                light_t_max = np.float32(t_j)
                t_lim = np.float32(t_j)
                light_hit = True
                alpha = np.float32(1.0)

        hit = _intersect(scene, o, d, t_lim)
        if bool(hit.valid[0]):
            surf = geometry.surface_at(
                hit,
                jnp.asarray(scene.tri_v),
                jnp.asarray(scene.tri_n),
                jnp.asarray(scene.tri_uv),
                jnp.asarray(scene.tri_mesh),
            )
            mesh = int(surf.mesh[0])
            prio = int(scene.mesh_priority[mesh])
            frame, desc = make_bsdf(
                scene,
                jnp.asarray([mesh]),
                surf.st,
                surf.sn,
                surf.dpds,
                jnp.asarray([alpha_tweak]),
            )
            p_hit = np.asarray(surf.p[0])
            gn = np.asarray(surf.gn[0])

            # IsectIsValid
            eta_outer = np.float32(1.0)
            if isect_list:
                if isect_list[-1][0] != mesh:
                    eta_outer = np.float32(isect_list[-1][2])
                elif len(isect_list) >= 2:
                    eta_outer = np.float32(isect_list[-2][2])
            valid = all(prio >= e[1] for e in isect_list)

            if valid:
                if bounce == 0:
                    alpha = np.float32(1.0)
                wo = bxdf.to_local(frame, _b1(-d).reshape(1, 3))

                # ---- EstimateDirect ----
                u_pick = scalar_rng.uniform_float()
                light_idx = int(min(u_pick, FLT_BEFORE_ONE) * n_lights)
                light = scene.lights[light_idx]
                l_direct = np.zeros(3, np.float32)

                sa = (scalar_rng.uniform_float(), scalar_rng.uniform_float())
                ub = scalar_rng.uniform_float()
                fA, wiA, pdfA, dflags, _, _ = bxdf.bsdf_sample_f(
                    desc,
                    wo,
                    jnp.asarray([ub], jnp.float32),
                    jnp.asarray([sa], jnp.float32),
                    jnp.ones(1, bool),
                    jnp.asarray([eta_outer]),
                    jnp.zeros(1, jnp.int32),
                )
                pdfA_v = float(pdfA[0])
                if pdfA_v > 0.0:
                    wiA_l = np.asarray(wiA[0])
                    wiA_w = np.asarray(bxdf.to_world(frame, wiA)[0])
                    flip = 1.0 if wiA_l[2] > 0 else -1.0
                    sh_o = p_hit + gn * SHADOW_BIAS * flip
                    ev = light_eval(
                        light, _b1(p_hit).reshape(1, 3), _b1(wiA_w).reshape(1, 3)
                    )
                    li_v = np.asarray(ev.le[0])
                    lpdf = float(ev.pdf[0])
                    t_light = float(ev.t[0])
                    if not _occluded(scene, sh_o, wiA_w, t_light):
                        spec = int(dflags[0]) & bxdf.SPECULAR
                        if not spec:
                            w = (pdfA_v * pdfA_v) / (
                                pdfA_v * pdfA_v + lpdf * lpdf
                            )
                            if lpdf > 0.0:
                                l_direct = l_direct + np.asarray(fA[0]) * li_v * abs(
                                    wiA_l[2]
                                ) * w / pdfA_v
                        else:
                            l_direct = l_direct + np.asarray(fA[0]) * li_v * abs(
                                wiA_l[2]
                            ) / pdfA_v

                sb = (scalar_rng.uniform_float(), scalar_rng.uniform_float())
                s_le, s_wi, s_pdf, s_t, _ = light_sample(
                    light, _b1(p_hit).reshape(1, 3), jnp.asarray([sb], jnp.float32)
                )
                lpdf = float(s_pdf[0])
                wiB_w = np.asarray(s_wi[0])
                wiB_l = np.asarray(bxdf.to_local(frame, s_wi)[0])
                flip = 1.0 if wiB_l[2] > 0 else -1.0
                sh_o = p_hit + gn * SHADOW_BIAS * flip
                if not _occluded(scene, sh_o, wiB_w, float(s_t[0])) and lpdf > 0.0:
                    pdfB = float(
                        bxdf.bsdf_pdf(
                            desc,
                            wo,
                            jnp.asarray([wiB_l]),
                            jnp.ones(1, bool),
                            jnp.asarray([eta_outer]),
                        )[0]
                    )
                    if pdfB > 0.0:
                        fB = np.asarray(
                            bxdf.bsdf_f(
                                desc,
                                wo,
                                jnp.asarray([wiB_l]),
                                jnp.ones(1, bool),
                                jnp.asarray([eta_outer]),
                            )[0]
                        )
                        w = (lpdf * lpdf) / (pdfB * pdfB + lpdf * lpdf)
                        l_direct = l_direct + fB * np.asarray(s_le[0]) * abs(
                            wiB_l[2]
                        ) * w / lpdf

                l_out = l_out + l_direct * np.float32(n_lights) * beta

                # ---- scatter ----
                ss = (scalar_rng.uniform_float(), scalar_rng.uniform_float())
                us = scalar_rng.uniform_float()
                fS, wiS, pdfS, nflags, alpha_i, eta_s = bxdf.bsdf_sample_f(
                    desc,
                    wo,
                    jnp.asarray([us], jnp.float32),
                    jnp.asarray([ss], jnp.float32),
                    jnp.zeros(1, bool),
                    jnp.asarray([eta_outer]),
                    jnp.asarray([flags], jnp.int32),
                )
                flags = int(nflags[0])
                eta_sampled = float(eta_s[0])
                pdfS_v = float(pdfS[0])
                if pdfS_v <= 0.0:
                    break
                alpha_tweak = np.float32(
                    (1.0 - gamma * float(alpha_i[0])) * alpha_tweak
                )
                wiS_l = np.asarray(wiS[0])
                beta = beta * np.asarray(fS[0]) * abs(wiS_l[2]) / pdfS_v
                flip = 1.0 if wiS_l[2] > 0 else -1.0
                o = p_hit + gn * SHADOW_BIAS * flip
                d = np.asarray(bxdf.to_world(frame, wiS)[0])
            else:
                o = p_hit + d * SHADOW_BIAS
                flags = bxdf.TRANSMISSIVE
                ue = scalar_rng.uniform_float()
                eta_sampled = float(
                    bxdf.bsdf_sample_eta(desc, jnp.asarray([ue], jnp.float32))[0]
                )

            if flags & bxdf.TRANSMISSIVE:
                # UpdateIsectList
                erased = False
                for k in range(len(isect_list) - 1, -1, -1):
                    if isect_list[k][0] == mesh:
                        isect_list.pop(k)
                        erased = True
                        break
                if not erased:
                    isect_list.append((mesh, prio, eta_sampled))

            if bounce > 3:
                q = max(float(beta.sum()) * 0.33333, 0.0)
                u_rr = scalar_rng.uniform_float()
                if q >= u_rr:
                    beta = beta / np.float32(q)
                else:
                    break
            t_lim = np.float32(np.inf)
        else:
            if bounce == 0:
                if light_hit:
                    l_out = le.copy()
                break
            else:
                break  # dead lane: reference spins without effect

    return np.append(l_out, alpha), scalar_rng


def render_oracle(scene, params):
    """RenderSession::Render + RenderTile transcription for tiny images.

    Returns (film_buffer (totalH, totalW, 5), final_rng_states (N,))."""
    from tests.test_rng import _scalar_latin_square  # reuse transcription

    fb = int(np.ceil(params.filter_width))
    total_w = params.image_width + 2 * fb
    total_h = params.image_height + 2 * fb
    nbx = -(-params.image_width // params.bucket_size)
    nby = -(-params.image_height // params.bucket_size)
    render_w = min(nbx * params.bucket_size, total_w)
    render_h = min(nby * params.bucket_size, total_h)

    table = film.filter_table()
    buf = np.zeros((total_h, total_w, 5), np.float32)
    states = np.zeros(render_w * render_h, np.uint32)

    for y in range(render_h):
        for x in range(render_w):
            r = rng.ScalarRNG()
            r.seed(y * total_w + x)
            samples = []
            # inline Latin square using the shared scalar transcription
            inv = np.float32(1.0 / params.spp)
            for i in range(params.spp):
                sx = np.float32((np.float32(i) + np.float32(r.uniform_float())) * inv)
                sy = np.float32((np.float32(i) + np.float32(r.uniform_float())) * inv)
                samples.append([sx, sy])
            samples = np.array(samples, np.float32)
            for i in range(params.spp):
                c = r.uniform_int32(params.spp - 1 - i)
                samples[[i, c], 0] = samples[[c, i], 0]
                c = r.uniform_int32(params.spp - 1 - i)
                samples[[i, c], 1] = samples[[c, i], 1]

            for i in range(params.spp):
                s = samples[i]
                o, d = camera.cast_rays(
                    jnp.asarray(scene.cam_to_world),
                    scene.fov,
                    params.image_width,
                    params.image_height,
                    jnp.asarray([x], jnp.int32),
                    jnp.asarray([y], jnp.int32),
                    jnp.asarray([s]),
                )
                l_a, r = li_alpha(r, np.asarray(o[0]), np.asarray(d[0]), scene, params)
                coords = np.array(
                    [[x + fb + s[0], y + fb + s[1]]], np.float32
                )
                buf = np.asarray(
                    film.splat(
                        jnp.asarray(buf),
                        jnp.asarray(coords),
                        jnp.asarray(l_a[None]),
                        params.filter_width,
                        jnp.asarray(table),
                    )
                )
            states[y * render_w + x] = r.y
    return buf, states
