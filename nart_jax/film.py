"""Film: Gaussian filter splatting as a differentiable scatter-add.

Parity: RenderSession::AddSample + the precomputed filter table
(src/core/render.cpp:23-70, 127-130) and Gaussian() (render.h:23-32).  The
reference splats into per-bucket tiles and merges serially; splatting into
one (totalH, totalW, 5) buffer is mathematically identical (the merge is a
plain overlap-add) and maps to a single XLA scatter-add per wavefront.

Channel layout: [r, g, b, a, filterWeightSum].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

FILTER_TABLE_RES = 64


def gaussian(width, x):
    """render.h:23-32 (sigma = width/3, hard zero at x >= width)."""
    sigma = width / 3.0
    g = (1.0 / np.sqrt(2.0 * np.pi * sigma * sigma)) * np.exp(
        -(x * x) / (2.0 * sigma * sigma)
    )
    return np.where(x >= width, 0.0, g).astype(np.float32)


def filter_table():
    """64-entry table: Gaussian(width=63, x=i)  (render.cpp:127-130)."""
    i = np.arange(FILTER_TABLE_RES, dtype=np.float32)
    return gaussian(np.float32(FILTER_TABLE_RES - 1), i)


def splat(film, coords, l_alpha, filter_width, table):
    """Scatter one wavefront of samples into the film.

    Args:
      film: (totalH, totalW, 5) accumulator.
      coords: (N, 2) sample coords in total-image space (x, y).
      l_alpha: (N, 4) RGBA radiance.
      filter_width: static float.
      table: (64,) filter table.
    """
    fw = np.float32(filter_width)
    k = int(np.ceil(2.0 * filter_width)) + 1  # max taps per axis
    sx, sy = coords[..., 0], coords[..., 1]
    x0 = jnp.floor(sx - fw).astype(jnp.int32)
    y0 = jnp.floor(sy - fw).astype(jnp.int32)
    x1 = jnp.ceil(sx + fw).astype(jnp.int32)
    y1 = jnp.ceil(sy + fw).astype(jnp.int32)

    taps = jnp.arange(k, dtype=jnp.int32)
    tx = x0[..., None] + taps[None, :]  # (N, K)
    ty = y0[..., None] + taps[None, :]
    mx = tx < x1[..., None]
    my = ty < y1[..., None]

    # (N, K, K) tap grid
    gx = tx[:, None, :]  # x varies over last axis
    gy = ty[:, :, None]
    mask = (mx[:, None, :] & my[:, :, None]).astype(jnp.float32)

    dist_x = gx.astype(jnp.float32) + 0.5 - sx[:, None, None]
    dist_y = gy.astype(jnp.float32) + 0.5 - sy[:, None, None]
    dist = jnp.sqrt(dist_x * dist_x + dist_y * dist_y)
    idx = ((dist / fw) * FILTER_TABLE_RES).astype(jnp.int32) & 0xFF  # u8 cast
    w = table[jnp.minimum(idx, FILTER_TABLE_RES - 1)] * mask  # (N, K, K)

    h_tot, w_tot, _ = film.shape
    gx_c = jnp.clip(gx, 0, w_tot - 1)
    gy_c = jnp.clip(gy, 0, h_tot - 1)
    in_img = (gx >= 0) & (gx < w_tot) & (gy >= 0) & (gy < h_tot)
    w = w * in_img.astype(jnp.float32)

    vals = jnp.concatenate(
        [
            l_alpha[:, None, None, :] * w[..., None],
            w[..., None],
        ],
        axis=-1,
    )  # (N, K, K, 5)
    flat_idx = (gy_c * w_tot + gx_c).reshape(-1)
    film_flat = film.reshape(-1, 5)
    film_flat = film_flat.at[flat_idx].add(
        vals.reshape(-1, 5), mode="drop"
    )
    return film_flat.reshape(h_tot, w_tot, 5)


def _tap_weight(sx, sy, x0, y0, x1, y1, dx, dy, fw, table):
    """Weight of the single tap (dy, dx) for every lane: (N,) shapes only.

    Same math as splat() (AddSample parity, render.cpp:23-70), evaluated one
    static tap at a time — the (N, K, K, 64) one-hot table contraction of
    the previous formulation sent XLA's layout assignment into
    multi-minute compiles; 1-D per-tap lookups compile in seconds.
    """
    fdx, fdy = np.float32(dx), np.float32(dy)
    mask = (fdx >= x0) & (fdx < x1) & (fdy >= y0) & (fdy < y1)
    dist = jnp.sqrt((fdx + 0.5 - sx) ** 2 + (fdy + 0.5 - sy) ** 2)
    idx = ((dist / fw) * FILTER_TABLE_RES).astype(jnp.int32) & 0xFF  # u8 cast
    idx = jnp.minimum(idx, FILTER_TABLE_RES - 1)
    # one-hot contraction instead of a gather: bit-identical values, but
    # fusable (a gather inside a while_loop body also stalled layout)
    onehot = idx[..., None] == jnp.arange(FILTER_TABLE_RES, dtype=jnp.int32)
    w = jnp.sum(jnp.where(onehot, table, 0.0), axis=-1)
    return w * mask.astype(jnp.float32)


def _sample_window(jitter, filter_width, filter_bounds):
    """Per-lane sample position + tap bounds in window coords: (N,) each."""
    fw = np.float32(filter_width)
    sx = np.float32(filter_bounds) + jitter[..., 0]
    sy = np.float32(filter_bounds) + jitter[..., 1]
    return (
        sx, sy,
        jnp.floor(sx - fw), jnp.floor(sy - fw),
        jnp.ceil(sx + fw), jnp.ceil(sy + fw),
    )


def tap_weights(jitter, filter_width, table, filter_bounds):
    """Per-lane (N, K, K) Gaussian tap weights around the lane's own pixel.

    Tap (dy, dx) covers total-image pixel (pixel + dy, pixel + dx); the
    sample sits at pixel + filter_bounds + jitter in total coords.
    """
    fw = np.float32(filter_width)
    k = 2 * filter_bounds + 1
    sx, sy, x0, y0, x1, y1 = _sample_window(jitter, filter_width, filter_bounds)
    rows = [
        jnp.stack(
            [_tap_weight(sx, sy, x0, y0, x1, y1, dx, dy, fw, table)
             for dx in range(k)],
            axis=-1,
        )
        for dy in range(k)
    ]
    return jnp.stack(rows, axis=-2)  # (N, K, K)


def splat_windows(
    jitter, l_alpha, filter_width, table, render_w, render_h, filter_bounds,
    real_mask=None,
):
    """Fused tap-weight + overlap-add splat for grid lanes.

    Lane i is pixel (i % render_w, i // render_w); its sample sits at
    pixel + filter_bounds + jitter.  Each of the (2*fb+1)^2 taps computes
    its (N,) weight and adds the shifted (render_h, render_w, 5) image —
    no (N, K, K, 5) intermediate, trivially laid out by the compiler.
    Returns the (render_h + K, render_w + K, 5) accumulator (valid data in
    the first render_h + K - 1 / render_w + K - 1 rows/cols), the same
    contract as window_sum.  real_mask (N,) optionally zeroes padding lanes
    (the sharded slab path).
    """
    fw = np.float32(filter_width)
    k = 2 * filter_bounds + 1
    # (S, N, ...) batches (the per-chunk spp axis) fold into one tap loop:
    # the S per-tap images sum before the shifted add, so the whole chunk
    # costs one K^2 loop instead of S of them (compile size and runtime)
    if l_alpha.ndim == 2:
        jitter = jitter[None]
        l_alpha = l_alpha[None]
    s_dim = l_alpha.shape[0]
    sx, sy, x0, y0, x1, y1 = _sample_window(jitter, filter_width, filter_bounds)
    acc = jnp.zeros((render_h + k, render_w + k, 5), jnp.float32)
    for dy in range(k):
        for dx in range(k):
            w = _tap_weight(sx, sy, x0, y0, x1, y1, dx, dy, fw, table)
            if real_mask is not None:
                w = jnp.where(real_mask, w, 0.0)
            img = jnp.concatenate(
                [l_alpha * w[..., None], w[..., None]], axis=-1
            ).reshape(s_dim, render_h, render_w, 5).sum(axis=0)
            acc = acc.at[dy : dy + render_h, dx : dx + render_w].add(img)
    return acc


def splat_grid(
    film, jitter, l_alpha, filter_width, table, render_w, render_h,
    filter_bounds,
):
    """Dense splat for lanes that form the full row-major pixel grid.

    Mathematically identical to splat() (same tap weights), but instead of a
    32M-element scatter-add it reshapes the wavefront to an image and does
    (2*fb+1)^2 statically-shifted dense adds, with no atomics and a fixed
    summation order.  Lane i is pixel (i % render_w,
    i // render_w); its sample coord is pixel + filter_bounds + jitter.

    Taps can run off the film edge (the reference drops them at tile merge,
    render.cpp:192-193); the crop below does the same.
    """
    # fold the film ONE SAMPLE at a time: the per-pixel accumulation order
    # is then (sample 0, sample 1, ...) regardless of how the spp axis is
    # chunked across calls — the bit-identical chunk/checkpoint contract
    # (test_integrator.test_balanced_matches_regen asserts array_equal).
    # The sharded slab path uses the spp-fused splat_windows directly (its
    # contract vs single-chip is 1e-6, not bit-exact).
    #
    # The sample axis rides lax.scan, NOT a Python loop: a 16-sample chunk
    # unrolled to 16 x K^2 tap bodies was the single most expensive compile
    # of a render (67 s of the cold start at 512^2); the scan body compiles
    # once and the sequential fold is the same math.
    if l_alpha.ndim == 2:
        jitter = jitter[None]
        l_alpha = l_alpha[None]
    h_tot, w_tot, _ = film.shape

    def one_sample(film, sj):
        s_jitter, s_la = sj
        acc = splat_windows(
            s_jitter, s_la, filter_width, table, render_w, render_h,
            filter_bounds,
        )
        acc = acc[:h_tot, :w_tot]
        pad_h = h_tot - acc.shape[0]
        pad_w = w_tot - acc.shape[1]
        if pad_h > 0 or pad_w > 0:
            acc = jnp.pad(
                acc, ((0, max(pad_h, 0)), (0, max(pad_w, 0)), (0, 0))
            )
        return film + acc, None

    film, _ = jax.lax.scan(one_sample, film, (jitter, l_alpha))
    return film


def finalize(film, image_width, image_height, filter_bounds):
    """Normalise and crop: contribution / filterWeightSum over the image
    window (render.cpp:208-228).  Returns (H, W, 4) RGBA."""
    fb = filter_bounds
    crop = film[fb : fb + image_height, fb : fb + image_width]
    return crop[..., :4] / crop[..., 4:5]
