"""Lights: analytic disk/ring area lights + environment maps with CDF
importance sampling.

Parity: src/lights/{disklight,ringlight,environmentlight}.cpp and the
Piecewise2DDistribution sampler (texturepattern.cpp:72-109).  The light list
is static per scene, so light functions take a LightData record and are
unrolled (no dynamic dispatch); per-ray light *selection* is done by the
integrator with masked evaluation over the (small) light set.

Reference quirks preserved:
  * ring Sample_Li pdf = 1/(pi*(1-k)) / (pi*r^2)   [double-pi; k=inner/r]
    while ring Pdf()  = 1/(pi*(1-k^2)*r^2)          (ringlight.cpp:50,103)
  * env pdf jacobian 1/(4*pi*|sin theta|)           (environmentlight.cpp:25)
  * env tMax sentinel 2139095039.0 (int 0x7f7fffff as float)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .scene import (
    LIGHT_DISK,
    LIGHT_DISTANT,
    LIGHT_ENV,
    LIGHT_RING,
    Env2D,
    LightData,
)
from .sampling import uniform_sample_disk, uniform_sample_ring

PI = np.float32(np.pi)
TWO_PI = np.float32(2.0 * np.pi)
ENV_TMAX = np.float32(2139095039.0)  # 0x7f7fffff as float (parity)


def _safe_div(a, b):
    ok = b != 0.0
    return jnp.where(ok, a / jnp.where(ok, b, 1.0), 0.0)


class LightEval(NamedTuple):
    le: jnp.ndarray  # (N, 3) radiance (0 when pdf == 0)
    pdf: jnp.ndarray  # (N,) solid-angle pdf
    t: jnp.ndarray  # (N,) hit distance (inf when missed)


def _mm(a, b):
    """f32 matrix product at full precision (a GPU may otherwise run it
    in TF32, which keeps about three decimal digits)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _xform_point(xf, p):
    return _mm(p, xf[:3, :3].T) + xf[:3, 3]


def _xform_dir(xf, d):
    return _mm(d, xf[:3, :3].T)


def _le_value(light: LightData, st):
    """Le pattern value * intensity (constant or texture GetValue)."""
    if light.le_tex is None:
        le = jnp.broadcast_to(
            jnp.asarray(light.le_const), st.shape[:-1] + (3,)
        )
    else:
        from .select import auto_lut

        img = jnp.asarray(light.le_tex)
        h, w, _ = light.le_tex.shape
        u = jnp.clip(st[..., 0], 1e-4, 0.9999)
        v = jnp.clip(1.0 - st[..., 1], 1e-4, 0.9999)
        iu = (np.float32(w) * u).astype(jnp.int32)
        iv = (np.float32(h) * v).astype(jnp.int32)
        le = auto_lut(iv * w + iu, h * w)(img.reshape(h * w, 3))
    return le * light.intensity


def _disk_like_eval(light: LightData, p, wi, is_ring: bool):
    """Shared disk/ring Li + Pdf (disklight.cpp:62-104, ringlight.cpp:66-112)."""
    xf = jnp.asarray(light.xf)
    center = xf[:3, 3]
    n = _xform_dir(xf, jnp.asarray([0.0, 0.0, -1.0], jnp.float32))
    radius = np.float32(light.radius)

    wi_dot_n = _mm(wi, n)
    plane_d = _mm(center, n)
    t = _safe_div(plane_d - _mm(p, n), wi_dot_n)
    p_hit = p + t[..., None] * wi
    delta = p_hit - center

    ux = _xform_dir(xf, jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    uy = _xform_dir(xf, jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    u = _mm(delta, ux) / radius
    v = _mm(delta, uy) / radius
    st = jnp.stack([(u + 1.0) * 0.5, 1.0 - (v + 1.0) * 0.5], axis=-1)

    dist2 = jnp.sum(delta * delta, axis=-1)
    ok = (wi_dot_n < 0.0) & (t >= 0.0) & (dist2 <= radius * radius)
    if is_ring:
        inner = np.float32(light.inner_radius)
        ok &= dist2 >= inner * inner
        area_pdf = np.float32(
            1.0
            / (
                np.pi
                * (1.0 - (light.inner_radius**2) / (light.radius**2))
                * light.radius**2
            )
        )
    else:
        area_pdf = np.float32(1.0 / (np.pi * light.radius**2))
    pdf = jnp.where(ok, area_pdf * _safe_div(t * t, -wi_dot_n), 0.0)

    le = jnp.where((pdf > 0.0)[..., None], _le_value(light, st), 0.0)
    t_out = jnp.where(pdf > 0.0, t, np.float32(np.inf))
    return LightEval(le=le, pdf=pdf, t=t_out)


def _disk_like_sample(light: LightData, p, u2, is_ring: bool):
    """Sample_Li (disklight.cpp:25-60, ringlight.cpp:26-64).

    Returns (le, wi, pdf, t, st).
    """
    xf = jnp.asarray(light.xf)
    radius = np.float32(light.radius)
    if is_ring:
        xy, pdf0 = uniform_sample_ring(
            u2, np.float32(light.inner_radius / light.radius)
        )
        pdf0 = pdf0 / (PI * radius * radius)  # parity: double-pi quirk
    else:
        xy = uniform_sample_disk(u2)
        pdf0 = jnp.full(u2.shape[:-1], np.float32(1.0 / (np.pi * light.radius**2)))
    xy = xy * radius

    su = ((xy[..., 0] + 1.0) * 0.5) / radius
    sv = ((xy[..., 1] + 1.0) * 0.5) / radius
    st = jnp.stack([su, 1.0 - sv], axis=-1)

    sample_world = _xform_point(
        xf, jnp.stack([xy[..., 0], xy[..., 1], jnp.zeros_like(su)], -1)
    )
    n = _xform_dir(xf, jnp.asarray([0.0, 0.0, -1.0], jnp.float32))
    wi = sample_world - p
    dist = jnp.sqrt(jnp.sum(wi * wi, -1))
    wi = wi / jnp.where(dist == 0.0, 1.0, dist)[..., None]

    wi_dot_n = -_mm(wi, n)
    visible = wi_dot_n > 0.0
    pdf = jnp.where(visible, pdf0 * _safe_div(dist * dist, wi_dot_n), 0.0)
    le = jnp.where(visible[..., None], _le_value(light, st), 0.0)
    return le, wi, pdf, dist, st


# ---------------------------------------------------------------------------
# Environment light
# ---------------------------------------------------------------------------


def env2d_pdf(dist: Env2D, st):
    """Piecewise2DDistribution::Pdf with TexturePattern::Pdf's clamps
    (texturepattern.cpp:104-109, 158-166)."""
    from .select import auto_lut

    sx = jnp.minimum(st[..., 0], 0.9999)
    sy = jnp.minimum(st[..., 1], 0.9999)
    u = (sx * dist.width).astype(jnp.int32)
    v = (sy * dist.height).astype(jnp.int32)
    h, w = dist.height, dist.width
    marg = auto_lut(v, h)(jnp.asarray(dist.marg_pdf))
    cond = auto_lut(v * w + u, h * w)(
        jnp.asarray(dist.cond_pdf).reshape(h * w)
    )
    return marg * cond


def env2d_sample(dist: Env2D, u2):
    """Piecewise2DDistribution::Sample (texturepattern.cpp:72-102).

    Returns (uv (N,2), pdf (N,)).  Black-row lanes return pdf 0 and uc 0
    (the reference leaves pdf at the caller's initial 0 — same effect).
    """
    from .select import auto_lut

    marg_cdf = jnp.asarray(dist.marg_cdf)
    marg_pdf = jnp.asarray(dist.marg_pdf)
    cond_cdf = jnp.asarray(dist.cond_cdf)
    cond_pdf = jnp.asarray(dist.cond_pdf)
    h, w = dist.height, dist.width
    inv_h, inv_w = np.float32(1.0 / h), np.float32(1.0 / w)

    sy = u2[..., 1]
    if dist.marg_inv is not None:
        # bracketed inverse-CDF search: the (2h)-entry table bounds the
        # bin to a 1-4 wide bracket, and marg_steps (build-time worst
        # case, typically 1-3) exact bisection steps finish — vs the
        # log2(h)-step rolled while-loop jnp.searchsorted lowers to
        marg_inv = jnp.asarray(dist.marg_inv)
        m_sz = marg_inv.shape[0]
        j = (sy * np.float32(m_sz - 1)).astype(jnp.int32)
        lo = auto_lut(j, m_sz)(marg_inv)
        hi = auto_lut(j + 1, m_sz)(marg_inv)
        for _ in range(dist.marg_steps):
            mid = (lo + hi + 1) // 2
            go = auto_lut(mid, h + 1)(marg_cdf) <= sy
            lo = jnp.where(go, mid, lo)
            hi = jnp.where(go, hi, mid - 1)
        lb = lo
    else:
        lb = (
            jnp.searchsorted(marg_cdf, sy, side="right").astype(jnp.int32)
            - 1
        )
    lb = jnp.clip(lb, 0, h)  # BinarySearch range [0, h]
    vc = (
        _safe_div(sy - auto_lut(lb, h + 1)(marg_cdf),
                  auto_lut(jnp.minimum(lb, h - 1), h)(marg_pdf))
        + lb.astype(jnp.float32) * inv_h
    )
    vc = jnp.minimum(vc, np.float32(0.9999999))
    v = (vc * h).astype(jnp.int32)

    marg_v = auto_lut(v, h)(marg_pdf)
    row_ok = marg_v > 0.0
    sx = u2[..., 0]
    cc_flat = cond_cdf.reshape(h * (w + 1))
    if dist.cond_inv is not None:
        # row-bracketed search via flat gathers: never materialises the
        # (N, w+1) per-lane CDF rows the rowwise compare-sum needed
        cond_inv = jnp.asarray(dist.cond_inv)
        mc_sz = cond_inv.shape[1]
        ci_flat = cond_inv.reshape(h * mc_sz)
        jc = (sx * np.float32(mc_sz - 1)).astype(jnp.int32)
        lo = auto_lut(v * mc_sz + jc, h * mc_sz)(ci_flat)
        hi = auto_lut(v * mc_sz + jc + 1, h * mc_sz)(ci_flat)
        for _ in range(dist.cond_steps):
            mid = (lo + hi + 1) // 2
            go = auto_lut(v * (w + 1) + mid, h * (w + 1))(cc_flat) <= sx
            lo = jnp.where(go, mid, lo)
            hi = jnp.where(go, hi, mid - 1)
        lb2 = jnp.clip(lo, 0, w)
    else:
        if h <= 64:  # one-hot matmul beats the row gather for small maps
            oh = (
                v[:, None] == jnp.arange(h, dtype=v.dtype)[None, :]
            ).astype(jnp.float32)
            row_cdf = _mm(oh, cond_cdf)  # (N, w+1)
        else:
            row_cdf = cond_cdf[v]  # (N, w+1)
        lb2 = jnp.clip(_rowwise_searchsorted(row_cdf, sx), 0, w)
    cond_flat = cond_pdf.reshape(h * w)
    uc = (
        _safe_div(
            sx - auto_lut(v * (w + 1) + lb2, h * (w + 1))(cc_flat),
            auto_lut(v * w + jnp.minimum(lb2, w - 1), h * w)(cond_flat),
        )
        + lb2.astype(jnp.float32) * inv_w
    )
    uc = jnp.minimum(uc, np.float32(0.9999999))
    u = (uc * w).astype(jnp.int32)
    pdf = jnp.where(
        row_ok, marg_v * auto_lut(v * w + u, h * w)(cond_flat), 0.0
    )
    uc = jnp.where(row_ok, uc, 0.0)
    return jnp.stack([uc, vc], axis=-1), pdf


def _rowwise_searchsorted(rows, vals):
    """searchsorted(side=right)-1 per row: rows (N, K), vals (N,)."""
    return (
        jnp.sum(rows <= vals[..., None], axis=-1).astype(jnp.int32) - 1
    )


def _env_st(wi):
    """Direction -> lat-long st with the reference's pi phi-offset
    (environmentlight.cpp:11-21)."""
    theta = jnp.arccos(jnp.clip(wi[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(wi[..., 1], wi[..., 0]) + PI
    phi = jnp.where(phi > TWO_PI, phi - TWO_PI, phi)
    phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)
    st = jnp.stack([1.0 - phi / TWO_PI, 1.0 - theta / PI], axis=-1)
    return st, theta


def _env_eval(light: LightData, p, wi):
    st, theta = _env_st(wi)
    if light.env2d is not None:
        pdf = env2d_pdf(light.env2d, st)
    else:
        pdf = jnp.ones(wi.shape[:-1], jnp.float32)  # constant pattern Pdf()=1
    sin_t = jnp.abs(jnp.sin(theta))
    pdf = pdf * np.float32(0.25 / np.pi) * _safe_div(jnp.ones_like(sin_t), sin_t)
    le = _le_value(light, st)
    t = jnp.full(wi.shape[:-1], ENV_TMAX)
    return LightEval(le=le, pdf=pdf, t=t)


def _env_sample(light: LightData, p, u2):
    """environmentlight.cpp:31-64."""
    if light.env2d is not None:
        uv, pdf = env2d_sample(light.env2d, u2)
    else:
        uv, pdf = u2, jnp.ones(u2.shape[:-1], jnp.float32)
    theta = (1.0 - uv[..., 1]) * PI
    phi = (1.0 - uv[..., 0]) * TWO_PI + PI
    phi = jnp.where(phi > TWO_PI, phi - TWO_PI, phi)
    phi = jnp.where(phi < 0.0, phi + TWO_PI, phi)
    sin_t = jnp.sin(theta)
    wi = jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, jnp.cos(theta)], axis=-1
    )
    # Le fetched at the *sampled* uv (TexturePattern::Sample,
    # texturepattern.cpp:131-155): same clamps as GetValue on (u, 1-v)
    st_fetch = jnp.stack([uv[..., 0], uv[..., 1]], axis=-1)
    if light.le_tex is not None:
        img = jnp.asarray(light.le_tex)
        h, w, _ = light.le_tex.shape
        uu = jnp.clip(uv[..., 0], 1e-4, 0.9999)
        vv = jnp.clip(1.0 - uv[..., 1], 1e-4, 0.9999)
        iu = (np.float32(w) * uu).astype(jnp.int32)
        iv = (np.float32(h) * vv).astype(jnp.int32)
        le = img[iv, iu] * light.intensity
    else:
        le = jnp.broadcast_to(
            jnp.asarray(light.le_const) * light.intensity,
            u2.shape[:-1] + (3,),
        )
    sin_abs = jnp.abs(sin_t)
    pdf = pdf * np.float32(0.25 / np.pi) * _safe_div(jnp.ones_like(sin_abs), sin_abs)
    t = jnp.full(u2.shape[:-1], ENV_TMAX)
    return le, wi, pdf, t, st_fetch


# ---------------------------------------------------------------------------
# Distant light (delta directional)
# ---------------------------------------------------------------------------
# Parity: src/lights/distantlight.cpp — defined in the reference but never
# constructible from JSON (scene.cpp:894-923); exposed here as an extension.


def _distant_eval(light: LightData, p, wi):
    """Li: a delta light is never hit by a ray (distantlight.cpp:11-15)."""
    shape = wi.shape[:-1]
    return LightEval(
        le=jnp.zeros(shape + (3,)),
        pdf=jnp.zeros(shape),
        t=jnp.full(shape, np.float32(np.inf)),
    )


def _distant_sample(light: LightData, p, u2):
    """Sample_Li: wi = -direction, pdf = 1 (distantlight.cpp:17-23).

    direction = (0,0,-1,0) * LightToWorld, same row-vector convention as
    the disk/ring normal.
    """
    xf = jnp.asarray(light.xf)
    direction = _xform_dir(xf, jnp.asarray([0.0, 0.0, -1.0], jnp.float32))
    shape = u2.shape[:-1]
    wi = jnp.broadcast_to(-direction, shape + (3,))
    pdf = jnp.ones(shape)
    le = jnp.broadcast_to(
        jnp.asarray(light.le_const) * light.intensity,
        shape + (3,),
    )
    # shadow ray range: the reference leaves lightIsect.tMax at Infinity
    t = jnp.full(shape, np.float32(np.inf))
    st = jnp.zeros(shape + (2,))
    return le, wi, pdf, t, st


# ---------------------------------------------------------------------------
# Packed area-light tables: O(1)-in-light-count SELECTED evaluation
# ---------------------------------------------------------------------------
# The integrator's light-sampling strategy evaluates only light[index] per
# lane; unrolling every light and masking is O(L*N) per bounce — the
# many-light wall.  Constant-Le disk/ring lights share one closed form, so
# their parameters pack into small tables: gather the selected light's row
# (L is tiny — the gathers are free) and evaluate ONCE.  Env / distant /
# textured-Le lights keep the per-light masked path (they carry per-light
# texture/CDF arrays that cannot be table-packed).


class AreaLightPack(NamedTuple):
    index: tuple  # original light-list indices covered by this pack
    center: jnp.ndarray  # (L, 3)
    n: jnp.ndarray  # (L, 3) emission normal
    ux: jnp.ndarray  # (L, 3)
    uy: jnp.ndarray  # (L, 3)
    radius: jnp.ndarray  # (L,)
    inner_k2: jnp.ndarray  # (L,) (inner/radius)^2 — 0 for disks
    is_ring: jnp.ndarray  # (L,) bool
    area_pdf: jnp.ndarray  # (L,) eval-side area pdf
    pdf0_ring_scale: jnp.ndarray  # (L,) sample-side 1/(pi r^2) factor
    le: jnp.ndarray  # (L, 3) le_const * intensity (0 for textured rows)
    intensity: jnp.ndarray  # (L,)
    tex_off: jnp.ndarray  # (L,) int32 atlas offset, -1 = constant Le
    tex_w: jnp.ndarray  # (L,) int32
    tex_h: jnp.ndarray  # (L,) int32
    tex_atlas: jnp.ndarray  # (T, 3) f32 concatenated Le textures (or (1,3))


def pack_area_lights(lights):
    """Pack disk/ring lights (constant OR textured Le) into SoA tables;
    returns (pack | None, rest_idx).

    rest_idx are the original indices NOT covered (env/distant).  Textured
    Le images are concatenated into one flat atlas with per-row
    (off, w, h); selected-light evaluation then needs ONE gather
    regardless of the light count."""
    idx, rows = [], []
    rest = []
    for i, li in enumerate(lights):
        if li.kind in (LIGHT_DISK, LIGHT_RING):
            idx.append(i)
            rows.append(li)
        else:
            rest.append(i)
    if not idx:
        return None, tuple(rest)
    xfs = [jnp.asarray(li.xf) for li in rows]
    zneg = jnp.asarray([0.0, 0.0, -1.0], jnp.float32)
    xpos = jnp.asarray([1.0, 0.0, 0.0], jnp.float32)
    ypos = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
    tex_off, tex_w, tex_h, chunks = [], [], [], []
    off = 0
    for li in rows:
        if li.le_tex is None:
            tex_off.append(-1)
            tex_w.append(0)
            tex_h.append(0)
        else:
            h, w, _ = li.le_tex.shape
            tex_off.append(off)
            tex_w.append(w)
            tex_h.append(h)
            chunks.append(jnp.reshape(jnp.asarray(li.le_tex), (h * w, 3)))
            off += h * w
    atlas = (jnp.concatenate(chunks) if chunks
             else jnp.zeros((1, 3), jnp.float32))
    pack = AreaLightPack(
        index=tuple(idx),
        center=jnp.stack([xf[:3, 3] for xf in xfs]),
        n=jnp.stack([_xform_dir(xf, zneg) for xf in xfs]),
        ux=jnp.stack([_xform_dir(xf, xpos) for xf in xfs]),
        uy=jnp.stack([_xform_dir(xf, ypos) for xf in xfs]),
        radius=jnp.asarray([li.radius for li in rows], jnp.float32),
        inner_k2=jnp.asarray(
            [
                (li.inner_radius / li.radius) ** 2 if li.kind == LIGHT_RING
                else 0.0
                for li in rows
            ],
            jnp.float32,
        ),
        is_ring=jnp.asarray(
            [li.kind == LIGHT_RING for li in rows], bool
        ),
        area_pdf=jnp.asarray(
            [
                1.0 / (np.pi * (1.0 - (li.inner_radius / li.radius) ** 2)
                       * li.radius**2)
                if li.kind == LIGHT_RING
                else 1.0 / (np.pi * li.radius**2)
                for li in rows
            ],
            jnp.float32,
        ),
        pdf0_ring_scale=jnp.asarray(
            [1.0 / (np.pi * li.radius**2) for li in rows], jnp.float32
        ),
        le=jnp.stack(
            [
                jnp.zeros(3, jnp.float32) if li.le_tex is not None
                else jnp.asarray(li.le_const) * li.intensity
                for li in rows
            ]
        ),
        intensity=jnp.asarray([li.intensity for li in rows], jnp.float32),
        tex_off=jnp.asarray(tex_off, jnp.int32),
        tex_w=jnp.asarray(tex_w, jnp.int32),
        tex_h=jnp.asarray(tex_h, jnp.int32),
        tex_atlas=atlas,
    )
    return pack, tuple(rest)


def _pack_st(pack, lut, delta):
    """Disk-parameterisation st of the SELECTED row (parity with
    _disk_like_eval's st construction)."""
    r = lut(pack.radius)
    u = jnp.sum(delta * lut(pack.ux), axis=-1) / r
    v = jnp.sum(delta * lut(pack.uy), axis=-1) / r
    return jnp.stack([(u + 1.0) * 0.5, 1.0 - (v + 1.0) * 0.5], axis=-1)


def _pack_le(pack, lut, st):
    """Le * intensity of the selected row: constant table or ONE atlas
    gather (parity with _le_value's clamps/v-flip)."""
    le = lut(pack.le)
    if pack.tex_atlas.shape[0] <= 1:
        return le
    off = lut(pack.tex_off)
    w = lut(pack.tex_w)
    h = lut(pack.tex_h)
    u = jnp.clip(st[..., 0], 1e-4, 0.9999)
    v = jnp.clip(1.0 - st[..., 1], 1e-4, 0.9999)
    iu = (w.astype(jnp.float32) * u).astype(jnp.int32)
    iv = (h.astype(jnp.float32) * v).astype(jnp.int32)
    fetched = pack.tex_atlas[jnp.maximum(off, 0) + iv * w + iu]
    fetched = fetched * lut(pack.intensity)[..., None]
    return jnp.where((off >= 0)[..., None], fetched, le)


def area_pack_nearest(pack: AreaLightPack, o, d, t_lim):
    """Nearest packed light along each ray — the per-bounce light pass
    (pathintegrator.cpp:167-182) over ALL pack rows at once.

    (N, L) geometry via matmuls instead of a per-light python loop of
    separate ops; the Le fetch happens ONCE for the argmin row.  Returns
    (le, t (=t_lim where no hit), hit)."""
    from .select import small_lut

    nT = pack.n  # (L, 3)
    wi_dot_n = _mm(d, nT.T)  # (N, L)
    plane_d = jnp.sum(pack.center * pack.n, axis=-1)  # (L,)
    t = _safe_div(plane_d[None, :] - _mm(o, nT.T), wi_dot_n)
    p_hit = o[:, None, :] + t[..., None] * d[:, None, :]  # (N, L, 3)
    delta = p_hit - pack.center[None]
    dist2 = jnp.sum(delta * delta, axis=-1)
    r2 = pack.radius * pack.radius
    ok = (
        (wi_dot_n < 0.0)
        & (t >= 0.0)
        & (dist2 <= r2[None, :])
        & (dist2 >= (pack.inner_k2 * r2)[None, :])
    )
    t_ok = jnp.where(ok, t, np.float32(np.inf))
    sel = jnp.argmin(t_ok, axis=-1)
    t_best = jnp.min(t_ok, axis=-1)
    hit = t_best < t_lim
    lut = small_lut(sel, pack.radius.shape[0])
    delta_sel = jnp.sum(
        jnp.where(
            (sel[:, None] == jnp.arange(pack.radius.shape[0]))[..., None],
            delta, 0.0,
        ),
        axis=1,
    )
    st = _pack_st(pack, lut, delta_sel)
    le = jnp.where(hit[:, None], _pack_le(pack, lut, st), 0.0)
    return le, jnp.where(hit, t_best, t_lim), hit


def area_pack_eval(pack: AreaLightPack, sel, p, wi):
    """Li of the per-lane SELECTED packed light: sel (N,) rows of the pack.

    Same math as _disk_like_eval on one-hot-looked-up parameters (st/Le
    constant); see select.small_lut for why not gathers."""
    from .select import small_lut

    lut = small_lut(sel, pack.radius.shape[0])
    center = lut(pack.center)
    n = lut(pack.n)
    radius = lut(pack.radius)
    wi_dot_n = jnp.sum(wi * n, axis=-1)
    plane_d = jnp.sum(center * n, axis=-1)
    t = _safe_div(plane_d - jnp.sum(p * n, axis=-1), wi_dot_n)
    p_hit = p + t[..., None] * wi
    delta = p_hit - center
    dist2 = jnp.sum(delta * delta, axis=-1)
    r2 = radius * radius
    ok = (wi_dot_n < 0.0) & (t >= 0.0) & (dist2 <= r2)
    ok &= dist2 >= lut(pack.inner_k2) * r2  # 0 for disks: no-op
    pdf = jnp.where(
        ok, lut(pack.area_pdf) * _safe_div(t * t, -wi_dot_n), 0.0
    )
    st = _pack_st(pack, lut, delta)
    le = jnp.where((pdf > 0.0)[..., None], _pack_le(pack, lut, st), 0.0)
    t_out = jnp.where(pdf > 0.0, t, np.float32(np.inf))
    return LightEval(le=le, pdf=pdf, t=t_out)


def area_pack_sample(pack: AreaLightPack, sel, p, u2):
    """Sample_Li of the per-lane SELECTED packed light.

    Disk and ring sampling share the warp up to the ring's annulus remap
    (sampling.cpp:18-31) and the double-pi pdf quirk — both expressed with
    per-lane selects over the looked-up parameters."""
    from .select import small_lut

    lut = small_lut(sel, pack.radius.shape[0])
    radius = lut(pack.radius)
    is_ring = lut(pack.is_ring)
    k2 = lut(pack.inner_k2)
    k = jnp.sqrt(k2)

    # ring mix quirk parity (sampling.cpp:18-31 via uniform_sample_ring)
    xy_d = uniform_sample_disk(u2)
    xy_r, pdf_r = uniform_sample_ring(u2, k)
    xy = jnp.where(is_ring[..., None], xy_r, xy_d)
    pdf0 = jnp.where(
        is_ring,
        pdf_r * lut(pack.pdf0_ring_scale),  # double-pi quirk parity
        lut(pack.area_pdf),
    )
    xy = xy * radius[..., None]

    sample_world = (
        lut(pack.center)
        + xy[..., 0:1] * lut(pack.ux)
        + xy[..., 1:2] * lut(pack.uy)
    )
    n = lut(pack.n)
    wi = sample_world - p
    dist = jnp.sqrt(jnp.sum(wi * wi, -1))
    wi = wi / jnp.where(dist == 0.0, 1.0, dist)[..., None]
    wi_dot_n = -jnp.sum(wi * n, axis=-1)
    visible = wi_dot_n > 0.0
    pdf = jnp.where(visible, pdf0 * _safe_div(dist * dist, wi_dot_n), 0.0)
    # sample-side st parity with _disk_like_sample (post-scale xy, the
    # reference's own formula including its divide-after-offset quirk)
    su = ((xy[..., 0] + 1.0) * 0.5) / radius
    sv = ((xy[..., 1] + 1.0) * 0.5) / radius
    st = jnp.stack([su, 1.0 - sv], axis=-1)
    le = jnp.where(visible[..., None], _pack_le(pack, lut, st), 0.0)
    return le, wi, pdf, dist


# ---------------------------------------------------------------------------
# Public dispatch (static per light)
# ---------------------------------------------------------------------------


def light_eval(light: LightData, p, wi) -> LightEval:
    """Light::Li — radiance looking along wi from p, with pdf and distance."""
    if light.kind == LIGHT_DISK:
        return _disk_like_eval(light, p, wi, is_ring=False)
    if light.kind == LIGHT_RING:
        return _disk_like_eval(light, p, wi, is_ring=True)
    if light.kind == LIGHT_ENV:
        return _env_eval(light, p, wi)
    if light.kind == LIGHT_DISTANT:
        return _distant_eval(light, p, wi)
    raise ValueError(f"unknown light kind {light.kind}")


def light_sample(light: LightData, p, u2):
    """Light::Sample_Li — returns (le, wi, pdf, dist, st)."""
    if light.kind == LIGHT_DISK:
        return _disk_like_sample(light, p, u2, is_ring=False)
    if light.kind == LIGHT_RING:
        return _disk_like_sample(light, p, u2, is_ring=True)
    if light.kind == LIGHT_ENV:
        return _env_sample(light, p, u2)
    if light.kind == LIGHT_DISTANT:
        return _distant_sample(light, p, u2)
    raise ValueError(f"unknown light kind {light.kind}")
