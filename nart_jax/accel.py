"""LBVH acceleration structure: Morton-ordered build + wavefront traversal.

Role parity: reference src/core/bvh.cpp (uniform-grid chunks in an octree of
bounding volumes, priority-queue traversal).  The replacement here is a
linear BVH (SURVEY.md §3.6): triangles are sorted by the
Morton code of their centroid, grouped into fixed-size leaves, and a complete
binary tree of AABBs is built bottom-up over the leaf sequence.  Traversal is
an explicit-stack wavefront walk: every live ray advances in lockstep under
`lax.while_loop`, with masked stack ops and near-child-first ordering — the
idiomatic XLA formulation of "stackless/short-stack" GPU traversal.

The build is array-parallel (numpy on host at scene bake; the same code runs
under jnp if device-side rebuilds are ever needed — the tree layout is
implicit, no pointer chasing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Hit, edge_fn, intersect_chunk, ray_shear
from .tree import pytree_dataclass

INF = np.float32(np.inf)


def _expand_bits(v):
    """Spread 10 bits over 30 (every third position)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(x, y, z):
    """30-bit Morton code from [0,1)^3 coordinates (uint32 numpy)."""

    def q(a):
        return np.clip((a * 1024.0), 0, 1023).astype(np.uint32)

    return (
        (_expand_bits(q(x)) << 2) | (_expand_bits(q(y)) << 1) | _expand_bits(q(z))
    )


@pytree_dataclass(meta_fields=("n_leaves", "leaf_size", "depth"))
@dataclass
class BVH:
    """Complete binary tree over Morton-ordered leaves (array layout).

    Node i's children are 2i+1 and 2i+2; leaves occupy the last `n_leaves`
    slots.  Leaf j covers triangles [j*leaf_size, (j+1)*leaf_size) of the
    *reordered* soup; `order` maps reordered -> original triangle ids.
    """

    node_lo: Any  # (n_nodes, 3)
    node_hi: Any  # (n_nodes, 3)
    order: Any  # (T_padded,) int32 — original tri id, -1 = padding
    tri_v: Any  # (T_padded, 3, 3) reordered vertices
    n_leaves: int  # power of two
    leaf_size: int
    depth: int  # tree depth (root = 0)


def build_bvh(tri_v: np.ndarray, leaf_size: int = 8) -> BVH:
    tri_v = np.asarray(tri_v, np.float32)
    t = len(tri_v)
    n_leaves = 1 << max(
        0, int(np.ceil(np.log2(max(1, (t + leaf_size - 1) // leaf_size))))
    )

    from . import _native

    native = _native.lbvh_build(tri_v, leaf_size, n_leaves)
    if native is not None:
        node_lo, node_hi, order_p, tv = native
        return BVH(
            node_lo=jnp.asarray(node_lo),
            node_hi=jnp.asarray(node_hi),
            order=jnp.asarray(order_p),
            tri_v=jnp.asarray(tv),
            n_leaves=n_leaves,
            leaf_size=leaf_size,
            depth=int(np.log2(n_leaves)),
        )
    return _build_bvh_py(tri_v, leaf_size)


def _build_bvh_py(tri_v: np.ndarray, leaf_size: int = 8) -> BVH:
    """Pure-Python twin of the native builder (behavior-defining fallback)."""
    t = len(tri_v)
    lo = tri_v.min(axis=1)  # (T, 3)
    hi = tri_v.max(axis=1)
    centroid = 0.5 * (lo + hi)
    scene_lo = lo.min(axis=0)
    scene_hi = hi.max(axis=0)
    extent = np.maximum(scene_hi - scene_lo, 1e-12)
    unit = (centroid - scene_lo) / extent
    codes = morton3(unit[:, 0], unit[:, 1], unit[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_leaves = 1 << max(0, int(np.ceil(np.log2(max(1, (t + leaf_size - 1) // leaf_size)))))
    t_pad = n_leaves * leaf_size
    order_p = np.full(t_pad, -1, np.int32)
    order_p[:t] = order
    tv = np.zeros((t_pad, 3, 3), np.float32)
    tv[:t] = tri_v[order]
    # padding triangles: degenerate, AABB collapsed to +inf so they never hit
    lo_p = np.full((t_pad, 3), INF, np.float32)
    hi_p = np.full((t_pad, 3), -INF, np.float32)
    lo_p[:t] = lo[order]
    hi_p[:t] = hi[order]

    n_nodes = 2 * n_leaves - 1
    node_lo = np.full((n_nodes, 3), INF, np.float32)
    node_hi = np.full((n_nodes, 3), -INF, np.float32)
    leaf0 = n_leaves - 1
    node_lo[leaf0:] = lo_p.reshape(n_leaves, leaf_size, 3).min(axis=1)
    node_hi[leaf0:] = hi_p.reshape(n_leaves, leaf_size, 3).max(axis=1)
    for i in range(leaf0 - 1, -1, -1):
        node_lo[i] = np.minimum(node_lo[2 * i + 1], node_lo[2 * i + 2])
        node_hi[i] = np.maximum(node_hi[2 * i + 1], node_hi[2 * i + 2])

    return BVH(
        node_lo=jnp.asarray(node_lo),
        node_hi=jnp.asarray(node_hi),
        order=jnp.asarray(order_p),
        tri_v=jnp.asarray(tv),
        n_leaves=n_leaves,
        leaf_size=leaf_size,
        depth=int(np.log2(n_leaves)),
    )


def resolve_accel_kind(kind: str) -> str:
    """'auto' -> the one-launch Pallas walk (pallas_accel.py) on a GPU
    backend, the lockstep walk of this module elsewhere.  The kernel is
    compiled for the card only; interpret mode is never chosen here."""
    if kind != "auto":
        return kind
    return "pallas" if jax.default_backend() == "gpu" else "bvh"


def _slab_test(o, inv_d, t_min, t_max, lo, hi):
    """Ray-AABB slab test.  Returns (hit, t_entry).

    Empty boxes (the padding leaves of the complete tree and their
    ancestors: lo = +inf > hi = -inf) give near = -inf and far = +inf on
    every axis, which the interval test alone would call a hit; the
    lo <= hi check rejects them."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(near, axis=-1), t_min)
    t_exit = jnp.minimum(jnp.min(far, axis=-1), t_max)
    return (t_enter <= t_exit) & (lo[..., 0] <= hi[..., 0]), t_enter


def intersect_bvh(o, d, t_min, t_max, bvh: BVH, max_iters: int | None = None):
    """Nearest-hit traversal for a ray wavefront.

    Lockstep masked traversal: each live ray pops one node per iteration;
    internal nodes push their children nearest-first; leaf nodes run the
    vectorised watertight test on `leaf_size` gathered triangles.  Rays whose
    stack empties go idle; the loop ends when all are idle.

    Returns a Hit with triangle ids in ORIGINAL soup numbering.
    """
    n = o.shape[0]
    shear = ray_shear(d)
    # guard axis-aligned rays: 0*inf NaNs in the slab test would poison it
    inv_d = 1.0 / jnp.where(d == 0.0, np.float32(1e-30), d)
    stack_depth = bvh.depth + 2
    leaf0 = bvh.n_leaves - 1

    stack = jnp.zeros((n, stack_depth), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pre-pushed at slot 0
    t_best = jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)
    tri_best = jnp.full((n,), -1, jnp.int32)
    u_best = jnp.zeros((n,))
    v_best = jnp.zeros((n,))
    rows = jnp.arange(n)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, tri_best, u_best, v_best = state
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(live, stack[rows, top], 0)
        sp = jnp.where(live, sp - 1, sp)

        lo = bvh.node_lo[node]
        hi = bvh.node_hi[node]
        box_hit, _ = _slab_test(o, inv_d, t_min, t_best, lo, hi)
        box_hit &= live

        is_leaf = node >= leaf0
        # --- leaf path: intersect the leaf's triangles
        do_tri = box_hit & is_leaf
        leaf_idx = jnp.maximum(node - leaf0, 0)
        base = leaf_idx * bvh.leaf_size
        tri_ids = base[:, None] + jnp.arange(bvh.leaf_size)[None, :]  # (N, K)
        tv = bvh.tri_v[tri_ids]  # (N, K, 3, 3)
        t, idx, uu, vv = _intersect_gathered(
            o, d, shear, t_min, jnp.where(do_tri, t_best, -INF), tv
        )
        better = do_tri & (idx >= 0) & (t < t_best)
        reordered = base + jnp.maximum(idx, 0)
        t_best = jnp.where(better, t, t_best)
        tri_best = jnp.where(better, bvh.order[reordered], tri_best)
        u_best = jnp.where(better, uu, u_best)
        v_best = jnp.where(better, vv, v_best)

        # --- internal path: push children, nearest first
        push = box_hit & ~is_leaf
        c1 = 2 * node + 1
        c2 = 2 * node + 2
        h1, e1 = _slab_test(o, inv_d, t_min, t_best, bvh.node_lo[c1], bvh.node_hi[c1])
        h2, e2 = _slab_test(o, inv_d, t_min, t_best, bvh.node_lo[c2], bvh.node_hi[c2])
        swap = e2 < e1  # push far child first so near child pops first
        first = jnp.where(swap, c2, c1)
        second = jnp.where(swap, c1, c2)
        h_first = jnp.where(swap, h2, h1)
        h_second = jnp.where(swap, h1, h2)

        push_far = push & h_first & h_second
        stack = stack.at[rows, jnp.where(push_far, sp, stack_depth - 1)].set(
            jnp.where(push_far, first, stack[rows, stack_depth - 1])
        )
        sp = sp + push_far.astype(jnp.int32)
        push_near = push & (h_first | h_second)
        near = jnp.where(h_second, second, first)
        stack = stack.at[rows, jnp.where(push_near, sp, stack_depth - 1)].set(
            jnp.where(push_near, near, stack[rows, stack_depth - 1])
        )
        sp = sp + push_near.astype(jnp.int32)
        return stack, sp, t_best, tri_best, u_best, v_best

    state = (stack, sp, t_best, tri_best, u_best, v_best)
    state = jax.lax.while_loop(cond, body, state)
    _, _, t, tri, u, v = state
    t = jnp.where(tri >= 0, t, INF)
    return Hit(t=t, tri=tri, u=u, v=v)


def _intersect_gathered(o, d, shear, t_min, t_best, tv):
    """Watertight test on per-ray gathered triangle sets (N, K, 3, 3).

    Same math as geometry.intersect_chunk but with per-ray triangles.
    """
    v0, v1, v2 = tv[:, :, 0], tv[:, :, 1], tv[:, :, 2]  # (N, K, 3)
    n = jnp.cross(v1 - v0, v2 - v0)
    d_dot_n = jnp.sum(d[:, None, :] * n, axis=-1)  # (N, K)
    t = (jnp.sum(v0 * n, axis=-1) - jnp.sum(o[:, None, :] * n, axis=-1)) / d_dot_n
    in_range = (t > t_min[:, None]) & (t < t_best[:, None])

    p = tv - o[:, None, None, :]
    perm = shear.perm[:, None, None, :]
    p = jnp.take_along_axis(p, jnp.broadcast_to(perm, p.shape), axis=-1)
    px = p[..., 0] + p[..., 2] * shear.sx[:, None, None]
    py = p[..., 1] + p[..., 2] * shear.sy[:, None, None]
    e0 = edge_fn(px[..., 1], py[..., 1], px[..., 2], py[..., 2])
    e1 = edge_fn(px[..., 2], py[..., 2], px[..., 0], py[..., 0])
    e2 = edge_fn(px[..., 0], py[..., 0], px[..., 1], py[..., 1])
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    hit = in_range & ~(neg & pos) & (jnp.abs(e0) + jnp.abs(e1) + jnp.abs(e2) != 0.0)

    t_hit = jnp.where(hit, t, INF)
    best = jnp.argmin(t_hit, axis=-1)
    rows = jnp.arange(o.shape[0])
    t_sel = t_hit[rows, best]
    inv_det = 1.0 / (e0 + e1 + e2)[rows, best]
    u = e0[rows, best] * inv_det
    v = e1[rows, best] * inv_det
    idx = jnp.where(jnp.isfinite(t_sel), best.astype(jnp.int32), -1)
    return t_sel, idx, u, v
