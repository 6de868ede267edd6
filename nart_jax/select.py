"""Small-K one-hot select/update helpers.

Per-row gathers/scatters on (N, K) tables — take_along_axis,
``x[rows, slot]``, ``x.at[rows, slot].set(v)`` — are replaced, for small
static K (BSDF lobes K=2, nested-dielectric stacks K=8, packed light tables
K=#lights), by a one-hot compare+select: a handful of full-width vector ops
that fuse with their neighbours and differentiate cleanly (its transpose is
the scatter-add the gather's backward pass needs).  Whether a plain gather
is faster on the GPU is unmeasured.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def row_pick(table, idx):
    """table (N, K), idx (N,) -> (N,) = table[r, idx[r]] per row.

    Out-of-range idx clamps like XLA gather."""
    k = table.shape[-1]
    ci = jnp.clip(idx, 0, k - 1)
    oh = ci[..., None] == jnp.arange(k, dtype=ci.dtype)
    if table.dtype == jnp.bool_:
        return jnp.any(oh & table, axis=-1)
    return jnp.sum(jnp.where(oh, table, 0), axis=-1)


def row_put(table, idx, val, mask=None):
    """Pure ``table.at[r, idx[r]].set(val[r])`` (rows where mask)."""
    k = table.shape[-1]
    ci = jnp.clip(idx, 0, k - 1)
    oh = ci[..., None] == jnp.arange(k, dtype=ci.dtype)
    if mask is not None:
        oh = oh & mask[..., None]
    val = jnp.asarray(val, table.dtype)
    if val.ndim < table.ndim:
        val = jnp.broadcast_to(val[..., None], table.shape)
    return jnp.where(oh, val, table)


def auto_lut(idx, n, threshold=64):
    """small_lut for tables up to `threshold` rows, plain gather beyond.

    Small textures / CDF tables (placeholder env maps, low-res light
    textures) pay the same ~0.5-0.7 ms scalar-loop gather cost per site
    as any other small table; real 1k-wide tables are cheapest as
    gathers (one-hot cost scales with n)."""
    if n <= threshold:
        return small_lut(idx, n)
    ci = jnp.clip(idx, 0, n - 1)

    def lut(table):
        return jnp.asarray(table)[ci]

    return lut


def small_lut(idx, n):
    """One-hot row lookups into (n, ...) tables for per-lane index idx.

    Returns lut(table): (n,) -> (N,) or (n, C) -> (N, C); bool tables go
    through any(); int tables round-trip exactly through f32 for values
    < 2^24 (ids/flags qualify): the products are pinned to full f32
    precision, since a GPU may otherwise run f32 matmuls in TF32, which
    keeps integers exact only below 2^11."""
    ci = jnp.clip(idx, 0, n - 1)
    oh = ci[..., None] == jnp.arange(n, dtype=ci.dtype)
    ohf = oh.astype(jnp.float32)

    def lut(table):
        t = jnp.asarray(table)
        if t.dtype == jnp.bool_:
            return jnp.any(oh & t[None, :], axis=-1)
        if jnp.issubdtype(t.dtype, jnp.integer):
            return jnp.round(
                jnp.matmul(ohf, t.astype(jnp.float32), precision=HIGHEST)
            ).astype(t.dtype)
        if t.ndim == 1:
            return jnp.matmul(ohf, t, precision=HIGHEST)
        return jnp.matmul(ohf, t, precision=HIGHEST)

    return lut
