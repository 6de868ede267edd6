"""Intersection tests: watertight test behavior + BVH vs brute-force oracle."""

import jax.numpy as jnp
import numpy as np

from nart_jax import accel, geometry


def _random_tris(n, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    base = g.uniform(-2, 2, (n, 1, 3))
    return (base + g.uniform(-scale, scale, (n, 3, 3))).astype(np.float32)


def _random_rays(n, seed=1):
    g = np.random.default_rng(seed)
    o = g.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_single_triangle_hit_miss():
    tri = jnp.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], jnp.float32)
    o = jnp.asarray([[0.2, 0.2, 1.0], [2.0, 2.0, 1.0]])
    d = jnp.asarray([[0.0, 0, -1.0], [0.0, 0, -1.0]])
    hit = geometry.intersect_brute(
        o, d, jnp.zeros(2), jnp.full(2, np.inf), tri
    )
    assert bool(hit.valid[0]) and not bool(hit.valid[1])
    np.testing.assert_allclose(float(hit.t[0]), 1.0, rtol=1e-6)
    # barycentric weights: p = v0*u + v1*v + v2*(1-u-v)
    u, v = float(hit.u[0]), float(hit.v[0])
    p = np.array([0, 0, 0]) * u + np.array([1, 0, 0]) * v + np.array(
        [0, 1, 0]
    ) * (1 - u - v)
    np.testing.assert_allclose(p[:2], [0.2, 0.2], atol=1e-5)


def test_tmin_tmax_respected():
    tri = jnp.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], jnp.float32)
    o = jnp.asarray([[0.2, 0.2, 1.0]])
    d = jnp.asarray([[0.0, 0, -1.0]])
    hit = geometry.intersect_brute(o, d, jnp.zeros(1), jnp.full(1, 0.5), tri)
    assert not bool(hit.valid[0])  # t=1 beyond tMax
    hit = geometry.intersect_brute(o, d, jnp.full(1, 1.5), jnp.full(1, np.inf), tri)
    assert not bool(hit.valid[0])  # t=1 below tMin


def test_watertight_shared_edge():
    # two triangles sharing an edge: rays through the shared edge must hit
    quad = np.array(
        [
            [[0, 0, 0], [1, 0, 0], [1, 1, 0]],
            [[0, 0, 0], [1, 1, 0], [0, 1, 0]],
        ],
        np.float32,
    )
    g = np.random.default_rng(3)
    xs = g.uniform(0.01, 0.99, 256).astype(np.float32)
    o = np.stack([xs, xs, np.ones_like(xs)], -1)  # along the diagonal edge
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (256, 1))
    hit = geometry.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), jnp.zeros(256), jnp.full(256, np.inf), jnp.asarray(quad)
    )
    assert bool(hit.valid.all()), "watertightness violated along shared edge"


def test_bvh_matches_brute():
    tris = jnp.asarray(_random_tris(300, seed=5, scale=0.5))
    o, d = _random_rays(512, seed=6)
    tmin = jnp.zeros(512)
    tmax = jnp.full(512, np.inf)
    brute = geometry.intersect_brute(o, d, tmin, tmax, tris)
    bvh = accel.build_bvh(np.asarray(tris), leaf_size=4)
    fast = accel.intersect_bvh(o, d, tmin, tmax, bvh)
    np.testing.assert_allclose(
        np.where(np.isinf(brute.t), 1e30, brute.t),
        np.where(np.isinf(fast.t), 1e30, fast.t),
        rtol=1e-6,
    )
    hit = np.asarray(brute.valid)
    np.testing.assert_array_equal(hit, np.asarray(fast.valid))
    # same triangle except measure-zero ties
    same = np.asarray(brute.tri) == np.asarray(fast.tri)
    assert same[hit].mean() > 0.99


def test_bvh_shadow_semantics():
    # occluded vs unoccluded with tmax at light distance
    tris = jnp.asarray([[[-.5, -.5, 0.0], [.5, -.5, 0], [0, .5, 0]]], jnp.float32)
    bvh = accel.build_bvh(np.asarray(tris), leaf_size=4)
    o = jnp.asarray([[0.0, 0, 1.0], [0.0, 0, 1.0]])
    d = jnp.asarray([[0.0, 0, -1.0], [0.0, 0, 1.0]])
    hit = accel.intersect_bvh(o, d, jnp.zeros(2), jnp.full(2, 2.0), bvh)
    assert bool(hit.valid[0]) and not bool(hit.valid[1])
    hit = accel.intersect_bvh(o, d, jnp.zeros(2), jnp.full(2, 0.5), bvh)
    assert not bool(hit.valid[0])  # occluder beyond shadow tmax


def test_surface_attributes():
    tris = jnp.asarray([[[0.0, 0, 0], [2, 0, 0], [0, 2, 0]]], jnp.float32)
    nrm = jnp.asarray([[[0.0, 0, 1], [0, 0, 1], [0, 0, 1]]], jnp.float32)
    uv = jnp.asarray([[[0.0, 0], [1, 0], [0, 1]]], jnp.float32)
    mesh = jnp.asarray([7], jnp.int32)
    o = jnp.asarray([[0.5, 0.5, 1.0]])
    d = jnp.asarray([[0.0, 0, -1.0]])
    hit = geometry.intersect_brute(o, d, jnp.zeros(1), jnp.full(1, np.inf), tris)
    surf = geometry.surface_at(hit, tris, nrm, uv, mesh)
    np.testing.assert_allclose(np.asarray(surf.p[0]), [0.5, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(surf.gn[0]), [0, 0, 1.0], atol=1e-6)
    assert int(surf.mesh[0]) == 7
    # uv at p: v1 weight = v (x/2), v2 weight = 1-u-v (y/2)
    np.testing.assert_allclose(np.asarray(surf.st[0]), [0.25, 0.25], atol=1e-5)


def test_slab_test_rejects_empty_padding_boxes():
    """The complete tree pads its leaves to a power of two with empty boxes
    (lo = +inf, hi = -inf), and so are their ancestors.  Their slabs give
    near = -inf and far = +inf on every axis: the slab test must still
    call them a miss, or every ray walks the whole padding subtree."""
    g = np.random.default_rng(4)
    n = 256
    o = jnp.asarray(g.normal(size=(n, 3)), jnp.float32)
    d = jnp.asarray(g.normal(size=(n, 3)), jnp.float32)
    inv_d = 1.0 / d
    lo = jnp.full((n, 3), np.inf, jnp.float32)
    hi = jnp.full((n, 3), -np.inf, jnp.float32)
    for t_max in (np.inf, 10.0):
        hit, _ = accel._slab_test(o, inv_d, jnp.zeros(n),
                                  jnp.full(n, t_max), lo, hi)
        assert not np.asarray(hit).any()
    # 9 leaves of 8 triangles pad to 16: the 7 padding leaves, and the
    # inner nodes over padding only, are the empty boxes
    tri = np.asarray(g.normal(size=(70, 3, 3)), np.float32)
    bvh = accel.build_bvh(tri)
    lo, hi = np.asarray(bvh.node_lo), np.asarray(bvh.node_hi)
    empty = (lo > hi).any(-1)
    leaf0 = bvh.n_leaves - 1
    assert bvh.n_leaves == 16
    np.testing.assert_array_equal(empty[leaf0:], np.arange(16) >= 9)
    inner = np.arange(leaf0)
    np.testing.assert_array_equal(
        empty[inner], empty[2 * inner + 1] & empty[2 * inner + 2]
    )
