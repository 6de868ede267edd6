"""Material resolution: per-hit BSDF descriptors + texture fetches.

Parity: the 5 Material::CreateBSDF implementations (src/materials/*.cpp) and
TexturePattern::GetValue (texturepattern.cpp:172-188).  Virtual CreateBSDF
becomes a data-parallel table lookup: gather per-mesh parameters, fetch
patterns, apply path-space roughening (alpha' = 1 - (1-alpha)*alphaTweak)
and resolve the lobe configuration per lane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import bxdf
from .scene import (
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_LAMBERT,
    MAT_PLASTIC,
    MAT_SPECULAR,
    SceneData,
)

HIGHEST = jax.lax.Precision.HIGHEST


def _tex_index(scene: SceneData, tex_id, st):
    """Flat texel index per lane (reference clamps/v-flip).

    texturepattern.cpp:172-188: u = clamp(st.x, 1e-4, .9999),
    v = clamp(1 - st.y, 1e-4, .9999), integer-truncated indices.
    The (w, h, off) per-texture tables are tiny; look them up by one-hot
    matmul rather than gather (see mesh_luts).  Texel offsets can exceed
    2^24 (a 4096^2 atlas), so `off` keeps full int precision by summing
    the one-hot * table products in int32.
    """
    tid = jnp.maximum(tex_id, 0)
    nt = scene.tex_w.shape[0]
    oh = (
        tid[:, None] == jnp.arange(nt, dtype=tid.dtype)[None, :]
    )
    ohf = oh.astype(jnp.float32)
    w = jnp.round(jnp.matmul(ohf, jnp.asarray(scene.tex_w, jnp.float32),
                             precision=HIGHEST)).astype(jnp.int32)
    h = jnp.round(jnp.matmul(ohf, jnp.asarray(scene.tex_h, jnp.float32),
                             precision=HIGHEST)).astype(jnp.int32)
    off = jnp.sum(
        jnp.where(oh, jnp.asarray(scene.tex_off, jnp.int32)[None, :], 0),
        axis=-1,
    )
    u = jnp.clip(st[..., 0], 1e-4, 0.9999)
    v = jnp.clip(1.0 - st[..., 1], 1e-4, 0.9999)
    iu = (w.astype(jnp.float32) * u).astype(jnp.int32)
    iv = (h.astype(jnp.float32) * v).astype(jnp.int32)
    return off + iv * w + iu


def tex_fetch(scene: SceneData, tex_id, st):
    """Nearest-neighbour texture lookup: (N, 3) f32 (differentiable)."""
    return scene.tex_data[_tex_index(scene, tex_id, st)]


def pack_tex_half(tex_data):
    """(P, 3) f32 -> (P, 2) u32 of RGB halves (r,g | b,0).

    The reference's in-memory textures ARE half (Imf::Rgba,
    texturepattern.cpp:111-128), so the f16 round-trip is exact parity.
    Halving the gathered element count halves the bytes each per-bounce
    texture fetch moves (unmeasured on the GPU).
    """
    bits = jax.lax.bitcast_convert_type(
        tex_data.astype(jnp.float16), jnp.uint16
    ).astype(jnp.uint32)
    w0 = bits[:, 0] | (bits[:, 1] << 16)
    return jnp.stack([w0, bits[:, 2]], axis=-1)


def tex_fetch_packed(tex_p2, scene: SceneData, tex_id, st):
    """Half-packed nearest-neighbour lookup: (N, 3) f32, NOT differentiable
    w.r.t. the texture (bitcasts); the render path uses it only when
    differentiable=False."""
    rows = tex_p2[_tex_index(scene, tex_id, st)]

    def half(u16):
        return jax.lax.bitcast_convert_type(
            u16.astype(jnp.uint16), jnp.float16
        ).astype(jnp.float32)

    r = half(rows[:, 0] & 0xFFFF)
    g = half(rows[:, 0] >> 16)
    b = half(rows[:, 1] & 0xFFFF)
    return jnp.stack([r, g, b], axis=-1)


def mesh_luts(mesh_id, n_mesh):
    """One-hot per-mesh table lookups: (lut_f, lut_i).

    A one-hot matmul instead of a gather from the tiny (n_mesh, C) table:
    differentiable without a scatter (its transpose is exactly the
    scatter-add the gather's backward needs); which of the two is faster
    on the GPU is unmeasured.  Values are exact in
    f32 for ints < 2^24 (mesh counts, texture ids, flags all qualify) at
    the pinned full-f32 precision (TF32 would keep only 2^11).
    """
    cm = jnp.clip(mesh_id, 0, n_mesh - 1)  # match gather's index clamping
    oh = (
        cm[:, None] == jnp.arange(n_mesh, dtype=mesh_id.dtype)[None, :]
    ).astype(jnp.float32)

    def lut_f(table):
        t = jnp.asarray(table, jnp.float32)
        return jnp.matmul(oh, t if t.ndim > 1 else t[:, None],
                          precision=HIGHEST)

    def lut_f1(table):
        return jnp.matmul(oh, jnp.asarray(table, jnp.float32),
                          precision=HIGHEST)

    def lut_i(table):
        return jnp.round(
            jnp.matmul(oh, jnp.asarray(table, jnp.float32), precision=HIGHEST)
        ).astype(jnp.int32)

    return lut_f, lut_f1, lut_i


def _pattern(scene, const_table, tex_table, mesh_id, st, slot, tex_p2=None,
             luts=None):
    """Constant-or-texture pattern value per lane: (N, 3).

    When the scene's STATIC tex_slots says no mesh binds a texture in this
    slot, the gather is skipped entirely."""
    if luts is not None:
        lut_f, _, lut_i = luts
        val = lut_f(const_table)
    else:
        val = const_table[mesh_id]
    if slot not in getattr(scene, "tex_slots", (slot,)):
        return val
    tid = lut_i(tex_table) if luts is not None else tex_table[mesh_id]
    if tex_p2 is not None:
        tex_val = tex_fetch_packed(tex_p2, scene, tid, st)
    else:
        tex_val = tex_fetch(scene, tid, st)
    return jnp.where((tid >= 0)[..., None], tex_val, val)


def make_bsdf(scene: SceneData, mesh_id, st, sn, dpds, alpha_tweak,
              tex_p2=None):
    """Resolve the per-hit BSDF: shading frame + lobe descriptor.

    Returns (frame, desc).  Mirrors the CreateBSDF logic of all five
    materials, including:
      * roughening chain alpha' = 1 - (1-alpha)*alphaTweak
      * glossy/glass degrade to delta lobes when alpha' <= 1e-4
        (plastic's specular slot threshold is 1e-3, plasticmaterial.cpp:39)
      * microfacet lobes get alpha0 = max(1e-4, alpha)
      * specular material has alpha = 0 (specularmaterial.cpp:26)
    """
    slots = getattr(scene, "tex_slots", None)
    if slots is None:  # legacy scenes without the static slot set
        slots = ("rho_d", "rho_s", "tau", "eta", "alpha", "normal")
    luts = mesh_luts(mesh_id, scene.mat_type.shape[0])
    lut_f, lut_f1, lut_i = luts
    mat = lut_i(scene.mat_type)

    def fetch1(tid, st):
        if tex_p2 is not None:
            return tex_fetch_packed(tex_p2, scene, tid, st)[..., 0]
        return tex_fetch(scene, tid, st)[..., 0]

    rho_d = _pattern(
        scene, scene.rho_d_const, scene.rho_d_tex, mesh_id, st, "rho_d",
        tex_p2, luts,
    )
    rho_s = _pattern(
        scene, scene.rho_s_const, scene.rho_s_tex, mesh_id, st, "rho_s",
        tex_p2, luts,
    )
    tau = _pattern(scene, scene.tau_const, scene.tau_tex, mesh_id, st, "tau",
                   tex_p2, luts)
    if "eta" in slots:
        eta_tid = lut_i(scene.eta_tex)
        eta = jnp.where(
            eta_tid >= 0,
            fetch1(eta_tid, st),
            lut_f1(scene.eta_const),
        )
    else:
        eta = lut_f1(scene.eta_const)
    if "alpha" in slots:
        alpha_tid = lut_i(scene.alpha_tex)
        alpha = jnp.where(
            alpha_tid >= 0,
            fetch1(alpha_tid, st),  # packed pre-squared
            lut_f1(scene.alpha_const),
        )
    else:
        alpha = lut_f1(scene.alpha_const)
    alpha = jnp.where(mat == MAT_SPECULAR, 0.0, alpha)
    alpha_prime = 1.0 - (1.0 - alpha) * alpha_tweak

    # shading frame (+ optional normal map; glass never has one — baked out
    # at scene load, matching the reference's GlassMaterial ctor bug)
    has_n = lut_i(scene.has_normal.astype(jnp.int32)) != 0
    if "normal" in slots:
        n_tid = lut_i(scene.normal_tex)
        if tex_p2 is not None:
            n_tex = tex_fetch_packed(tex_p2, scene, n_tid, st)
        else:
            n_tex = tex_fetch(scene, n_tid, st)
        n_val = jnp.where(
            (n_tid >= 0)[..., None],
            n_tex,
            lut_f(scene.normal_const),
        )
    else:
        n_val = lut_f(scene.normal_const)
    nn = n_val * 2.0 - 1.0
    frame_plain = bxdf.build_frame(sn, dpds)
    frame_mapped = bxdf.build_frame(sn, dpds, nn)
    frame = bxdf.Frame(
        t=jnp.where(has_n[..., None], frame_mapped.t, frame_plain.t),
        b=jnp.where(has_n[..., None], frame_mapped.b, frame_plain.b),
        n=jnp.where(has_n[..., None], frame_mapped.n, frame_plain.n),
    )

    micro = jnp.where(alpha_prime > 1e-4, bxdf.L_TS, bxdf.L_SPECULAR)
    lobe0 = jnp.select(
        [
            mat == MAT_LAMBERT,
            mat == MAT_SPECULAR,
            mat == MAT_GLOSSY,
            mat == MAT_GLASS,
            mat == MAT_PLASTIC,
        ],
        [
            jnp.full_like(mat, bxdf.L_LAMBERT),
            micro,
            micro,
            jnp.where(alpha_prime > 1e-4, bxdf.L_DIELECTRIC, bxdf.L_SPECDIEL),
            jnp.full_like(mat, bxdf.L_LAMBERT),
        ],
    )
    lobe1 = jnp.where(
        mat == MAT_PLASTIC,
        jnp.where(alpha_prime > 1e-3, bxdf.L_TS, bxdf.L_SPECULAR),
        -1,
    )
    n_lobes = jnp.where(mat == MAT_PLASTIC, 2, 1).astype(jnp.int32)

    desc = bxdf.BsdfDesc(
        n_lobes=n_lobes,
        lobe=jnp.stack([lobe0, lobe1], axis=-1).astype(jnp.int32),
        rho_d=rho_d,
        rho_s=rho_s,
        tau=tau,
        eta=eta,
        alpha0=jnp.maximum(np.float32(1e-4), alpha),
        alpha_prime=alpha_prime,
    )
    return frame, desc
