"""LBVH traversal as one Pallas kernel for NVIDIA GPUs (Triton route).

The lockstep walk of accel.intersect_bvh pops one node per ray per
`lax.while_loop` iteration over the whole wavefront; on XLA:GPU every
iteration is several kernel launches plus a read of the loop predicate by
the host.  Here the same walk runs inside one kernel launch:

  * one program per block of BLOCK rays; blocks share nothing;
  * inside, a `lax.while_loop` runs until every lane's stack is empty.  The
    per-lane stack (node id + entry distance, `stack_width(depth)` slots)
    is a (BLOCK, width) register tile updated by one-hot selects, like
    select.row_put;
  * node boxes and leaf triangles are gathered per lane from device memory
    (they stay in L2 for scenes of a few million triangles);
  * children are visited nearest first, and a popped node whose entry
    distance is beyond the lane's current best hit is skipped;
  * the any-hit variant retires a lane at its first hit (shadow rays).

The tree is accel.build_bvh's: node i has children 2i+1 and 2i+2, and the
last n_leaves nodes are leaves of leaf_size consecutive triangles of the
reordered soup.  The watertight test is geometry.intersect_chunk's, written
per lane.  The kernel returns the triangle id and t; the wrapper recomputes
u and v for that one triangle in plain jnp, so gradients are those of the
plain intersectors.  The kernel does no `dot`, so nothing runs in TF32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .accel import BVH, _intersect_gathered
from .geometry import Hit, edge_fn, ray_shear

INF = np.float32(np.inf)
BLOCK = 128  # rays per program: one lane per thread at NUM_WARPS = 4
NUM_WARPS = 4
_FAR = np.float32(1e8)  # padding rays start here and miss every box


def stack_width(depth: int) -> int:
    """Stack slots per lane: depth + 2 (a walk holds at most depth + 1
    entries), rounded up to a power of two for Triton's tile shapes."""
    return 1 << int(np.ceil(np.log2(depth + 2)))


def _walk_kernel(
    ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref, tmax_ref,
    box_ref, tri_ref, t_out_ref, id_out_ref,
    *, n_leaves, leaf_size, width, any_hit,
):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]
    b = t_min.shape[0]
    leaf0 = n_leaves - 1

    # watertight frame (geometry.ray_shear): major axis kz, minor kx, ky
    ad = [jnp.abs(c) for c in d]
    kz = jnp.where(
        ad[0] > ad[1],
        jnp.where(ad[0] > ad[2], 0, 2),
        jnp.where(ad[1] > ad[2], 1, 2),
    )
    kx = jnp.where(kz == 2, 0, kz + 1)
    ky = jnp.where(kx == 2, 0, kx + 1)

    def sel(v, axis):
        return jnp.where(axis == 0, v[0], jnp.where(axis == 1, v[1], v[2]))

    sz = 1.0 / sel(d, kz)
    sx = -sel(d, kx) * sz
    sy = -sel(d, ky) * sz
    o_a, o_b, o_c = sel(o, kx), sel(o, ky), sel(o, kz)
    inv_d = [1.0 / jnp.where(c == 0.0, np.float32(1e-30), c) for c in d]

    def slab(node, t_hi):
        """accel._slab_test per lane: (hit, t_entry); empty boxes (padding
        subtrees, lo > hi) never hit."""
        base = node * 6
        t_enter = t_min
        t_exit = t_hi
        for a in range(3):
            lo = box_ref[base + a]
            hi = box_ref[base + 3 + a]
            t0 = (lo - o[a]) * inv_d[a]
            t1 = (hi - o[a]) * inv_d[a]
            t_enter = jnp.maximum(t_enter, jnp.minimum(t0, t1))
            t_exit = jnp.minimum(t_exit, jnp.maximum(t0, t1))
            if a == 0:
                nonempty = lo <= hi
        return (t_enter <= t_exit) & nonempty, t_enter

    def tri_test(tri, t_hi, mask):
        """Watertight test of one triangle per lane; t (inf = no hit)."""
        base = tri * 9
        v = [
            [plgpu.load(tri_ref.at[base + 3 * k + a], mask=mask, other=0.0)
             for a in range(3)]
            for k in range(3)
        ]
        e1 = [v[1][a] - v[0][a] for a in range(3)]
        e2 = [v[2][a] - v[0][a] for a in range(3)]
        n = [
            e1[1] * e2[2] - e1[2] * e2[1],
            e1[2] * e2[0] - e1[0] * e2[2],
            e1[0] * e2[1] - e1[1] * e2[0],
        ]
        d_dot_n = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        o_dot_n = o[0] * n[0] + o[1] * n[1] + o[2] * n[2]
        v0_dot_n = v[0][0] * n[0] + v[0][1] * n[1] + v[0][2] * n[2]
        t = (v0_dot_n - o_dot_n) / d_dot_n
        p = []
        for k in range(3):
            cc = sel(v[k], kz) - o_c
            p.append((sel(v[k], kx) - o_a + cc * sx,
                      sel(v[k], ky) - o_b + cc * sy))
        w0 = edge_fn(p[1][0], p[1][1], p[2][0], p[2][1])
        w1 = edge_fn(p[2][0], p[2][1], p[0][0], p[0][1])
        w2 = edge_fn(p[0][0], p[0][1], p[1][0], p[1][1])
        neg = (w0 < 0) | (w1 < 0) | (w2 < 0)
        pos = (w0 > 0) | (w1 > 0) | (w2 > 0)
        hit = (
            mask & (t > t_min) & (t < t_hi) & ~(neg & pos)
            & (jnp.abs(w0) + jnp.abs(w1) + jnp.abs(w2) != 0.0)
        )
        return jnp.where(hit, t, INF)

    slot = jax.lax.broadcasted_iota(jnp.int32, (b, width), 1)

    def push(stack, entry, sp, m, node, t_enter):
        at = (slot == sp[:, None]) & m[:, None]
        stack = jnp.where(at, node[:, None], stack)
        entry = jnp.where(at, t_enter[:, None], entry)
        return stack, entry, sp + m.astype(jnp.int32)

    def cond(state):
        return jnp.max(state[2]) > 0

    def body(state):
        stack, entry, sp, t_best, best = state
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        at = slot == top[:, None]
        node = jnp.sum(jnp.where(at, stack, 0), axis=1)
        t_node = jnp.min(jnp.where(at, entry, INF), axis=1)
        sp = jnp.where(live, sp - 1, sp)
        # a node entered beyond the best hit so far cannot hold a closer one
        visit = live & (t_node <= t_best)
        is_leaf = node >= leaf0

        # leaf: the leaf_size triangles of the reordered soup
        do_tri = visit & is_leaf
        first = (node - leaf0) * leaf_size

        def leaf(carry):
            def one(k, c):
                t_best, best = c
                t = tri_test(first + k, t_best, do_tri)
                closer = t < t_best
                return (jnp.where(closer, t, t_best),
                        jnp.where(closer, first + k, best))

            return jax.lax.fori_loop(0, leaf_size, one, carry)

        t_best, best = jax.lax.cond(
            jnp.max(do_tri.astype(jnp.int32)) > 0,
            leaf,
            lambda c: c,
            (t_best, best),
        )
        if any_hit:
            # a shadow ray is done at its first hit
            sp = jnp.where(best >= 0, 0, sp)

        # internal: push the children that the ray enters, near one on top
        inner = visit & ~is_leaf
        c1 = jnp.where(inner, 2 * node + 1, 0)
        c2 = jnp.where(inner, 2 * node + 2, 0)
        h1, e1 = slab(c1, t_best)
        h2, e2 = slab(c2, t_best)
        h1 &= inner
        h2 &= inner
        swap = e2 < e1
        far_n = jnp.where(swap, c1, c2)
        far_e = jnp.where(swap, e1, e2)
        far_h = jnp.where(swap, h1, h2)
        near_n = jnp.where(swap, c2, c1)
        near_e = jnp.where(swap, e2, e1)
        near_h = jnp.where(swap, h2, h1)
        stack, entry, sp = push(stack, entry, sp, far_h, far_n, far_e)
        stack, entry, sp = push(stack, entry, sp, near_h, near_n, near_e)
        return stack, entry, sp, t_best, best

    init = (
        jnp.zeros((b, width), jnp.int32),  # root (node 0) in slot 0
        jnp.full((b, width), -INF, jnp.float32),
        jnp.ones((b,), jnp.int32),
        t_max,
        jnp.full((b,), -1, jnp.int32),
    )
    _, _, _, t_best, best = jax.lax.while_loop(cond, body, init)
    t_out_ref[...] = jnp.where(best >= 0, t_best, INF)
    id_out_ref[...] = best


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def _walk(o, d, t_min, t_max, bvh: BVH, any_hit, interpret):
    """(t, reordered triangle id) per ray; id -1 = miss."""
    n = o.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    pad = n_pad - n
    far = jnp.full((pad, 3), _FAR, jnp.float32)
    o = jnp.concatenate([o.astype(jnp.float32), far])
    d = jnp.concatenate([d.astype(jnp.float32), jnp.ones((pad, 3))])
    t_min = jnp.concatenate([t_min.astype(jnp.float32), jnp.zeros(pad)])
    t_max = jnp.concatenate([t_max.astype(jnp.float32), jnp.zeros(pad)])
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_min, t_max]
    boxes = jnp.concatenate([bvh.node_lo, bvh.node_hi], axis=1).reshape(-1)
    tris = bvh.tri_v.reshape(-1)

    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    kernel = functools.partial(
        _walk_kernel,
        n_leaves=bvh.n_leaves,
        leaf_size=bvh.leaf_size,
        width=stack_width(bvh.depth),
        any_hit=any_hit,
    )
    t, tri = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[lane] * 8 + [whole, whole],
        out_specs=[lane, lane],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_any_hit" if any_hit else "bvh_nearest_hit",
    )(*cols, boxes, tris)
    return t[:n], tri[:n]


def intersect_pallas(o, d, t_min, t_max, bvh: BVH, interpret=False):
    """Nearest hit (same contract as accel.intersect_bvh).

    Triangle ids are in the original soup numbering.  The walk sees its
    inputs through stop_gradient (traversal is a sampling decision); u and
    v are recomputed from the differentiable inputs for the one triangle
    hit, exactly as the watertight test computes them.
    """
    sg = jax.lax.stop_gradient
    t, tri = _walk(sg(o), sg(d), sg(t_min), sg(t_max), bvh,
                   any_hit=False, interpret=interpret)
    hit = tri >= 0
    reordered = jnp.maximum(tri, 0)
    tv = bvh.tri_v[reordered][:, None]  # (N, 1, 3, 3)
    _, _, u, v = _intersect_gathered(
        o, d, ray_shear(d), jnp.full_like(t_min, -INF),
        jnp.full_like(t_min, INF), tv,
    )
    return Hit(
        t=t,
        tri=jnp.where(hit, bvh.order[reordered], -1),
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, v, 0.0),
    )


def occluded_pallas(o, d, t_min, t_max, bvh: BVH, interpret=False):
    """Any hit in (t_min, t_max): (N,) bool, for shadow rays."""
    sg = jax.lax.stop_gradient
    _, tri = _walk(sg(o), sg(d), sg(t_min), sg(t_max), bvh,
                   any_hit=True, interpret=interpret)
    return tri >= 0
