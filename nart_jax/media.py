"""Participating media: density grids, majorants, AABB clipping.

Parity: src/core/media.cpp.  The reference's MajorantGrid has compile-time
width=1 (media.h:31-40) — a single global majorant voxel over the medium
AABB — so the 3D-DDA majorant iterator degenerates to one segment per ray;
we implement exactly that (the delta-tracking distribution is identical).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INF = np.float32(np.inf)


def density_lookup(density, p_unit):
    """Trilinear lookup at p in [0,1)^3.  DensityGrid::LookUp (media.cpp:9-45).

    density: (Z, Y, X); p_unit: (N, 3) xyz order.
    """
    rz, ry, rx = density.shape
    res = jnp.asarray([rx, ry, rz], jnp.float32)
    p = jnp.clip(p_unit, 0.0, 0.999) * (res - 1.0)
    lo = p.astype(jnp.int32)
    hi = lo + 1
    f = p - lo.astype(jnp.float32)

    def at(ix, iy, iz):
        return density[iz, iy, ix]

    x0 = at(lo[:, 0], lo[:, 1], lo[:, 2]) * (1 - f[:, 0]) + at(
        hi[:, 0], lo[:, 1], lo[:, 2]
    ) * f[:, 0]
    x1 = at(lo[:, 0], lo[:, 1], hi[:, 2]) * (1 - f[:, 0]) + at(
        hi[:, 0], lo[:, 1], hi[:, 2]
    ) * f[:, 0]
    x2 = at(lo[:, 0], hi[:, 1], lo[:, 2]) * (1 - f[:, 0]) + at(
        hi[:, 0], hi[:, 1], lo[:, 2]
    ) * f[:, 0]
    x3 = at(lo[:, 0], hi[:, 1], hi[:, 2]) * (1 - f[:, 0]) + at(
        hi[:, 0], hi[:, 1], hi[:, 2]
    ) * f[:, 0]
    y0 = x0 * (1 - f[:, 1]) + x2 * f[:, 1]
    y1 = x1 * (1 - f[:, 1]) + x3 * f[:, 1]
    return y0 * (1 - f[:, 2]) + y1 * f[:, 2]


def pack_density_cells(density):
    """Pack the grid's 2x2x2 cell corners into one (n_cells, 8) row table.

    The straightforward trilinear lookup costs EIGHT per-lane gathers per
    flight step; one 8-wide row per cell turns it into a single gather.  Corner k holds
    d[z + (k>>2 & 1), y + (k>>1 & 1), x + (k & 1)].
    """
    d = jnp.asarray(density)
    rows = [
        d[kz : d.shape[0] - 1 + kz,
          ky : d.shape[1] - 1 + ky,
          kx : d.shape[2] - 1 + kx]
        for kz in (0, 1) for ky in (0, 1) for kx in (0, 1)
    ]
    return jnp.stack(rows, axis=-1).reshape(-1, 8)


def density_lookup_cells(cells, grid_shape, p_unit):
    """Trilinear lookup against pack_density_cells' table.

    Bit-equivalent math to density_lookup up to product re-association
    (sum of 8 corner-weight products vs nested lerps — differences are
    ~1 ulp).  grid_shape is the ORIGINAL (Z, Y, X) density shape.
    """
    rz, ry, rx = grid_shape
    res = jnp.asarray([rx, ry, rz], jnp.float32)
    p = jnp.clip(p_unit, 0.0, 0.999) * (res - 1.0)
    lo = p.astype(jnp.int32)
    f = p - lo.astype(jnp.float32)
    idx = (lo[:, 2] * (ry - 1) + lo[:, 1]) * (rx - 1) + lo[:, 0]
    row = cells[idx]  # (N, 8) — the one gather
    wx = jnp.stack([1.0 - f[:, 0], f[:, 0]], -1)  # (N, 2)
    wy = jnp.stack([1.0 - f[:, 1], f[:, 1]], -1)
    wz = jnp.stack([1.0 - f[:, 2], f[:, 2]], -1)
    w = (
        wz[:, :, None, None] * wy[:, None, :, None] * wx[:, None, None, :]
    ).reshape(-1, 8)
    return jnp.sum(row * w, axis=-1)


def medium_properties_cells(medium, cells, p):
    """medium_properties with the packed-cell density table."""
    bmin = jnp.asarray(medium.bounds_min)
    bmax = jnp.asarray(medium.bounds_max)
    inside = jnp.all((p >= bmin) & (p <= bmax), axis=-1)
    p_unit = (p - bmin) / (bmax - bmin)
    dens = density_lookup_cells(
        cells, jnp.asarray(medium.density).shape, p_unit
    )
    sigma_a = jnp.asarray(medium.sigma_a) * dens
    sigma_s = jnp.asarray(medium.sigma_s) * dens
    le = jnp.asarray(medium.le) * dens[:, None]
    return inside, sigma_a, sigma_s, le


def clip_to_aabb(o, d, bounds_min, bounds_max):
    """Medium::SampleRay AABB slab clip (media.cpp:281-324).

    Returns (hit, t_min, t_max); t_min may be negative when inside.
    """
    inv_d = 1.0 / jnp.where(d == 0.0, np.float32(1e-30), d)
    t0 = (bounds_min - o) * inv_d
    t1 = (bounds_max - o) * inv_d
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    t_min = jnp.max(near, axis=-1)
    t_max = jnp.min(far, axis=-1)
    return t_min <= t_max, t_min, t_max


def medium_properties(medium, p):
    """Medium::SampleMedium (media.cpp:264-279): density-scaled coefficients.

    Returns (inside, sigma_a, sigma_s, le): all density-scaled.
    """
    bmin = jnp.asarray(medium.bounds_min)
    bmax = jnp.asarray(medium.bounds_max)
    inside = jnp.all((p >= bmin) & (p <= bmax), axis=-1)
    p_unit = (p - bmin) / (bmax - bmin)
    dens = density_lookup(jnp.asarray(medium.density), p_unit)
    sigma_a = jnp.asarray(medium.sigma_a) * dens
    sigma_s = jnp.asarray(medium.sigma_s) * dens
    le = jnp.asarray(medium.le) * dens[:, None]
    return inside, sigma_a, sigma_s, le
