"""Watertight ray-triangle intersection, vectorised over ray wavefronts.

Parity: reference src/core/geometry.cpp:3-115 — the PBRT-style
permute-and-shear watertight test with the exact same edge-function sign
logic, barycentrics, shading-normal/UV lerp and dpds/dpdt computation.

Everything here is data-parallel jnp over SoA buffers: rays are (N, 3)
arrays, triangles are (T, 3, 3) world-space vertex stacks.  The brute-force
intersector chunks triangles under `lax.scan` and serves as the correctness
oracle for the BVH (accel.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

INF = np.float32(np.inf)


def edge_fn(ax, ay, bx, by):
    """2D edge function ax*by - ay*bx, robust to FMA contraction.

    Watertightness relies on two triangles sharing an edge computing exactly
    negated edge values (same products, opposite order) so a ray through the
    edge is accepted by at least one of them (geometry.cpp:73-81).  XLA/LLVM
    codegen contracts the multiply-subtract into an FMA, leaving a rounding
    residue of inconsistent sign — which opens cracks.  Since the residue is
    bounded by ~ulp of the products, we snap |e| below that noise floor to
    exact zero: rays inside the sliver hit *both* triangles (harmless),
    instead of sometimes neither.
    """
    p1 = ax * by
    p2 = ay * bx
    e = p1 - p2
    noise = (jnp.abs(p1) + jnp.abs(p2)) * np.float32(2.0**-22)
    return jnp.where(jnp.abs(e) <= noise, np.float32(0.0), e)


class RayShear(NamedTuple):
    """Precomputed watertight-permutation constants (geometry.cpp:3-15)."""

    perm: jnp.ndarray  # (N, 3) int32 — [minor0, minor1, major]
    sx: jnp.ndarray  # (N,)
    sy: jnp.ndarray  # (N,)
    sz: jnp.ndarray  # (N,)


def ray_shear(d: jnp.ndarray) -> RayShear:
    ad = jnp.abs(d)
    # C++ tie-breaking: x>y ? (x>z ? 0 : 2) : (y>z ? 1 : 2)
    major = jnp.where(
        ad[..., 0] > ad[..., 1],
        jnp.where(ad[..., 0] > ad[..., 2], 0, 2),
        jnp.where(ad[..., 1] > ad[..., 2], 1, 2),
    ).astype(jnp.int32)
    minor0 = (major + 1) % 3
    minor1 = (major + 2) % 3

    # component selection by arithmetic select, not take_along_axis: the
    # two-way selects fuse into the surrounding elementwise code
    def sel(axis):
        return jnp.where(
            axis == 0, d[..., 0], jnp.where(axis == 1, d[..., 1], d[..., 2])
        )

    sz = 1.0 / sel(major)
    sx = -sel(minor0) * sz
    sy = -sel(minor1) * sz
    return RayShear(
        perm=jnp.stack([minor0, minor1, major], axis=-1), sx=sx, sy=sy, sz=sz
    )


class Hit(NamedTuple):
    """Per-ray nearest-hit record (mirrors Intersection, geometry.h:29-51)."""

    t: jnp.ndarray  # (N,) — inf when no hit
    tri: jnp.ndarray  # (N,) int32 — best triangle index (-1 = miss)
    u: jnp.ndarray  # (N,)
    v: jnp.ndarray  # (N,)

    @property
    def valid(self):
        return self.tri >= 0


def intersect_chunk(o, d, shear, t_min, t_best, tri_v):
    """Test N rays against a chunk of C triangles.

    Returns (t (N,), idx_in_chunk (N,), u, v) of the nearest *strictly
    closer than t_best* valid hit; idx -1 when none.

    Memory shape note: everything streams through (N, C) f32 buffers (no
    (N, C, 3, 3) intermediates) — the per-ray axis permutation is a masked
    3-way select of triangle coordinate columns, which XLA fuses into the
    edge-function arithmetic.  The select is exact (same f32 values as a
    gather), preserving watertight parity.
    """
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]  # (C, 3)
    n = jnp.cross(v1 - v0, v2 - v0)  # (C, 3) unnormalised geometric normal

    d_dot_n = (
        d[:, 0:1] * n[None, :, 0]
        + d[:, 1:2] * n[None, :, 1]
        + d[:, 2:3] * n[None, :, 2]
    )  # (N, C)
    o_dot_n = (
        o[:, 0:1] * n[None, :, 0]
        + o[:, 1:2] * n[None, :, 1]
        + o[:, 2:3] * n[None, :, 2]
    )
    v0_dot_n = jnp.sum(v0 * n, axis=-1)  # (C,)
    t = (v0_dot_n[None, :] - o_dot_n) / d_dot_n  # (N, C)

    in_range = (t > t_min[:, None]) & (t < t_best[:, None])

    # per-ray axis selection: axis_sel(arr (C,), axis_idx (N,)) -> (N, C)
    pa = shear.perm[:, 0:1]  # minor0 axis per ray
    pb = shear.perm[:, 1:2]  # minor1
    pc = shear.perm[:, 2:3]  # major

    def sel_tri(vc, axis):  # vc (C, 3), axis (N, 1) -> (N, C)
        return jnp.where(
            axis == 0,
            vc[None, :, 0],
            jnp.where(axis == 1, vc[None, :, 1], vc[None, :, 2]),
        )

    def sel_ray(vec, axis):  # vec (N, 3), axis (N, 1) -> (N, 1)
        return jnp.take_along_axis(vec, axis, axis=-1)

    o_a = sel_ray(o, pa)
    o_b = sel_ray(o, pb)
    o_c = sel_ray(o, pc)
    sx = shear.sx[:, None]
    sy = shear.sy[:, None]

    def corner_xy(vc):
        ca = sel_tri(vc, pa) - o_a  # translated, permuted coords
        cb = sel_tri(vc, pb) - o_b
        cc = sel_tri(vc, pc) - o_c
        return ca + cc * sx, cb + cc * sy

    p0x, p0y = corner_xy(v0)
    p1x, p1y = corner_xy(v1)
    p2x, p2y = corner_xy(v2)

    e0 = edge_fn(p1x, p1y, p2x, p2y)  # (N, C)
    e1 = edge_fn(p2x, p2y, p0x, p0y)
    e2 = edge_fn(p0x, p0y, p1x, p1y)

    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    esum = e0 + e1 + e2
    hit = in_range & ~(neg & pos) & (jnp.abs(e0) + jnp.abs(e1) + jnp.abs(e2) != 0.0)

    t_hit = jnp.where(hit, t, INF)
    best = jnp.argmin(t_hit, axis=-1)  # first-wins on ties, like the scan order
    rows = jnp.arange(o.shape[0])
    t_sel = t_hit[rows, best]
    inv_det = 1.0 / esum[rows, best]
    u = e0[rows, best] * inv_det
    v = e1[rows, best] * inv_det
    idx = jnp.where(jnp.isfinite(t_sel), best.astype(jnp.int32), -1)
    return t_sel, idx, u, v


def intersect_brute(o, d, t_min, t_max, tri_v, chunk=512):
    """Nearest-hit over all triangles; the accel-structure oracle.

    Scans triangle chunks with a running best (strictly-closer updates, so
    first triangle wins ties exactly like the reference's serial loop).
    """
    n_tri = tri_v.shape[0]
    pad = (-n_tri) % chunk
    tv = jnp.concatenate([tri_v, jnp.zeros((pad, 3, 3), tri_v.dtype)], axis=0)
    shear = ray_shear(d)
    n = o.shape[0]

    def body(carry, tv_chunk):
        t_best, tri_best, u_best, v_best, base = carry
        t, idx, u, v = intersect_chunk(o, d, shear, t_min, t_best, tv_chunk)
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        tri_best = jnp.where(better, base + idx, tri_best)
        u_best = jnp.where(better, u, u_best)
        v_best = jnp.where(better, v, v_best)
        return (t_best, tri_best, u_best, v_best, base + tv_chunk.shape[0]), None

    init = (
        jnp.minimum(jnp.broadcast_to(t_max, (n,)), INF),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros(n),
        jnp.zeros(n),
        jnp.int32(0),
    )
    (t, tri, u, v, _), _ = jax.lax.scan(
        body, init, tv.reshape(-1, chunk, 3, 3)
    )
    # rays that never beat t_max report miss
    t = jnp.where(tri >= 0, t, INF)
    return Hit(t=t, tri=tri, u=u, v=v)


class Surface(NamedTuple):
    """Full surface record at a hit (Intersection fields, geometry.h:29-51)."""

    p: jnp.ndarray  # (N, 3)
    gn: jnp.ndarray  # (N, 3) normalised geometric normal
    sn: jnp.ndarray  # (N, 3) lerped shading normal (NOT normalised — parity)
    st: jnp.ndarray  # (N, 2) texture coords
    dpds: jnp.ndarray  # (N, 3)
    dpdt: jnp.ndarray  # (N, 3)
    mesh: jnp.ndarray  # (N,) int32


def pack_surface_rows(tri_v, tri_n, tri_uv, tri_mesh):
    """Pack per-triangle surface attributes into one (T, 32) f32 row.

    Four separate per-hit gathers (tri_v (N,3,3), tri_n, tri_uv, tri_mesh)
    become one gather of a 32-float contiguous row per triangle (128
    bytes, one cache line each).  Layout: v0 v1 v2 (9) | n0 n1 n2 (9) |
    uv0 uv1 uv2 (6) | mesh-as-f32 (1) | pad (7).
    """
    t = tri_v.shape[0]
    row = jnp.concatenate(
        [
            jnp.reshape(tri_v, (t, 9)),
            jnp.reshape(tri_n, (t, 9)),
            jnp.reshape(tri_uv, (t, 6)),
            tri_mesh.astype(jnp.float32)[:, None],  # exact to 2^24
            jnp.zeros((t, 7), jnp.float32),
        ],
        axis=-1,
    )
    return row


def surface_at_packed(hit: Hit, surf_rows) -> Surface:
    """surface_at on the packed (T, 32) rows: ONE gather per wavefront."""
    idx = jnp.maximum(hit.tri, 0)
    r = surf_rows[idx]  # (N, 32)
    v = jnp.reshape(r[:, 0:9], (-1, 3, 3))
    nrm = jnp.reshape(r[:, 9:18], (-1, 3, 3))
    uv = jnp.reshape(r[:, 18:24], (-1, 3, 2))
    mesh = r[:, 24].astype(jnp.int32)
    return _surface_from_gathered(hit, v, nrm, uv, mesh)


def surface_at(hit: Hit, tri_v, tri_n, tri_uv, tri_mesh) -> Surface:
    """Gather and interpolate surface attributes for the best hits.

    Parity: geometry.cpp:88-113.  p is recomputed from barycentrics, sn/st
    lerp with weights (u, v, 1-u-v), dpds/dpdt from the UV determinant.
    """
    idx = jnp.maximum(hit.tri, 0)
    v = tri_v[idx]  # (N, 3, 3)
    nrm = tri_n[idx]
    uv = tri_uv[idx]
    return _surface_from_gathered(hit, v, nrm, uv, tri_mesh[idx])


def _surface_from_gathered(hit: Hit, v, nrm, uv, mesh) -> Surface:
    u, w_v = hit.u[:, None], hit.v[:, None]
    w2 = 1.0 - u - w_v
    p = v[:, 0] * u + v[:, 1] * w_v + v[:, 2] * w2
    gn_raw = jnp.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    gn = gn_raw / jnp.maximum(
        jnp.linalg.norm(gn_raw, axis=-1, keepdims=True), 1e-30
    )
    sn = nrm[:, 0] * u + nrm[:, 1] * w_v + nrm[:, 2] * w2
    st = uv[:, 0] * u + uv[:, 1] * w_v + uv[:, 2] * w2

    uv0, uv1, uv2 = uv[:, 0], uv[:, 1], uv[:, 2]
    uv_det = (uv0[:, 0] - uv2[:, 0]) * (uv1[:, 1] - uv2[:, 1]) - (
        uv0[:, 1] - uv2[:, 1]
    ) * (uv1[:, 0] - uv2[:, 0])
    inv_uv_det = 1.0 / uv_det  # reference TODO: no 0-det guard (matched)
    dpds = (
        (v[:, 0] - v[:, 2]) * (uv1[:, 1] - uv2[:, 1])[:, None]
        + (v[:, 1] - v[:, 2]) * (uv2[:, 1] - uv0[:, 1])[:, None]
    ) * inv_uv_det[:, None]
    dpdt = (
        (v[:, 0] - v[:, 2]) * (uv2[:, 0] - uv1[:, 0])[:, None]
        + (v[:, 1] - v[:, 2]) * (uv0[:, 0] - uv2[:, 0])[:, None]
    ) * inv_uv_det[:, None]
    return Surface(
        p=p, gn=gn, sn=sn, st=st, dpds=dpds, dpdt=dpdt, mesh=mesh
    )
