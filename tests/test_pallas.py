"""The Pallas LBVH walk (Triton route) vs the brute-force oracle.

The kernel runs here in Pallas interpret mode, which executes the same
kernel body (per-lane gathers, the register stack, the while loop) on the
CPU.  The compiled kernel is compared with intersect_brute on the card by
chip_smoke.py (phase 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nart_jax import pallas_accel
from nart_jax.accel import build_bvh
from nart_jax.geometry import intersect_brute
from nart_jax.pallas_accel import intersect_pallas, occluded_pallas

walk = functools.partial(intersect_pallas, interpret=True)
walk_any = functools.partial(occluded_pallas, interpret=True)


def _random_tris(n, rng, spread=3.0, size=0.5):
    tri = rng.normal(size=(n, 3, 3)).astype(np.float32) * size
    tri += rng.normal(size=(n, 1, 3)).astype(np.float32) * spread
    return tri


def _random_rays(n, rng, spread=4.0):
    o = rng.normal(size=(n, 3)).astype(np.float32) * spread
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _both(o, d, t_min, t_max, tri_v, leaf_size=8):
    args = [jnp.asarray(x) for x in (o, d, t_min, t_max)]
    hp = walk(*args, build_bvh(tri_v, leaf_size=leaf_size))
    hb = intersect_brute(*args, jnp.asarray(tri_v))
    return hp, hb


def _assert_same_hits(hp, hb):
    trip, trib = np.asarray(hp.tri), np.asarray(hb.tri)
    np.testing.assert_array_equal(trip, trib)
    hit = trib >= 0
    np.testing.assert_allclose(
        np.asarray(hp.t)[hit], np.asarray(hb.t)[hit], rtol=1e-5, atol=1e-6
    )
    assert np.isinf(np.asarray(hp.t)[~hit]).all()
    np.testing.assert_allclose(
        np.asarray(hp.u)[hit], np.asarray(hb.u)[hit], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(hp.v)[hit], np.asarray(hb.v)[hit], rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("n_tris", [5, 200, 700])
def test_intersect_clusters_matches_brute(n_tris):
    """Named for the cluster kernel this walk replaced; the cases are the
    same: random triangle soups of 5, 200 and 700 triangles."""
    rng = np.random.default_rng(n_tris)
    tri_v = _random_tris(n_tris, rng)
    n = 640
    o, d = _random_rays(n, rng)
    hp, hb = _both(o, d, np.full(n, 1e-4, np.float32),
                   np.full(n, np.inf, np.float32), tri_v)
    assert (np.asarray(hb.tri) >= 0).any()
    _assert_same_hits(hp, hb)


def test_finite_tmax_respected():
    rng = np.random.default_rng(7)
    tri_v = _random_tris(300, rng)
    bvh = build_bvh(tri_v)
    n = 256
    o, d = _random_rays(n, rng)
    t_min = jnp.full(n, 1e-4, jnp.float32)
    far = walk(jnp.asarray(o), jnp.asarray(d), t_min,
               jnp.full(n, np.inf, jnp.float32), bvh)
    # clamp each ray's tmax just below its own nearest hit -> all miss
    t_far = np.asarray(far.t)
    assert np.isfinite(t_far).any()
    t_clip = np.where(np.isfinite(t_far), t_far * 0.99, 1e-3)
    near = walk(jnp.asarray(o), jnp.asarray(d), t_min,
                jnp.asarray(t_clip, jnp.float32), bvh)
    assert (np.asarray(near.tri) == -1).all()


@pytest.mark.parametrize("n_tris", [5, 700])
def test_anyhit_matches_closest_hit_validity(n_tris):
    """The any-hit walk's boolean == nearest-hit validity, including finite
    per-ray t_max (the shadow-ray use: t_max = light distance) and culled
    lanes parked with t_max = 0."""
    rng = np.random.default_rng(n_tris + 1)
    tri_v = _random_tris(n_tris, rng)
    n = 512
    o, d = _random_rays(n, rng)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(
        rng.random(n) < 0.25, 0.0, rng.exponential(5.0, n)
    ).astype(np.float32)
    hp, hb = _both(o, d, t_min, t_max, tri_v)
    args = [jnp.asarray(x) for x in (o, d, t_min, t_max)]
    occ = walk_any(*args, build_bvh(tri_v))
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(hb.tri) >= 0)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))


def _grid_mesh(k=12):
    """A k x k grid of quads in z = 0 (shared edges and vertices)."""
    xs = np.linspace(-1.0, 1.0, k + 1, dtype=np.float32)
    tris = []
    for i in range(k):
        for j in range(k):
            a = [xs[i], xs[j], 0.0]
            b = [xs[i + 1], xs[j], 0.0]
            c = [xs[i + 1], xs[j + 1], 0.0]
            e = [xs[i], xs[j + 1], 0.0]
            tris += [[a, b, c], [a, c, e]]
    return np.asarray(tris, np.float32)


def _case(name, rng):
    """(tri_v, o, d, t_min, t_max, leaf_size) for one traversal edge case."""
    n = 1000  # not a multiple of BLOCK: exercises the lane padding
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    if name == "edges":
        # rays aimed at the grid's shared vertices and edge midpoints:
        # watertight means every one of them hits
        tri_v = _grid_mesh()
        g = np.linspace(-1.0, 1.0, 13, dtype=np.float32)[1:-1]
        pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
        pts = np.concatenate([pts, pts + [0.0, 1.0 / 12]])
        target = np.concatenate([pts, np.zeros((len(pts), 1))], -1)
        o = np.tile(np.asarray([[0.3, -0.2, 2.0]], np.float32),
                    (len(pts), 1))
        d = (target - o).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        m = len(pts)
        return tri_v, o, d, t_min[:m], t_max[:m], 8
    tri_v = _random_tris(400, rng)
    o, d = _random_rays(n, rng)
    leaf_size = 8
    if name == "axis_aligned":
        # zero direction components: the slab test's inv_d guard
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
        o = o * np.float32(0.3)
    elif name == "inside":
        # origins inside the mesh's bounds: every root box is entered
        o = tri_v.reshape(-1, 3)[rng.integers(0, 1200, n)] * np.float32(0.9)
    elif name == "parked":
        # dead lanes parked far away with t_max = 0, as the integrator does
        park = rng.random(n) < 0.5
        o = np.where(park[:, None], np.float32(1e8), o).astype(np.float32)
        t_max = np.where(park, 0.0, t_max).astype(np.float32)
    elif name == "single_leaf":
        tri_v = tri_v[:6]  # one leaf: the root itself is a leaf
    elif name == "wide_leaves":
        leaf_size = 16
    return tri_v, o, d, t_min, t_max, leaf_size


@pytest.mark.parametrize(
    "name",
    ["edges", "axis_aligned", "inside", "parked", "single_leaf",
     "wide_leaves"],
)
def test_walk_edge_cases_match_brute(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    tri_v, o, d, t_min, t_max, leaf_size = _case(name, rng)
    hp, hb = _both(o, d, t_min, t_max, tri_v, leaf_size=leaf_size)
    if name == "edges":
        # shared edges: both the walk and the oracle hit every ray, and
        # where they pick different triangles of an edge, t is the same
        trip, trib = np.asarray(hp.tri), np.asarray(hb.tri)
        assert (trip >= 0).all() and (trib >= 0).all()
        np.testing.assert_allclose(np.asarray(hp.t), np.asarray(hb.t),
                                   rtol=1e-6)
        return
    _assert_same_hits(hp, hb)


def test_gradients_match_lockstep_walk(monkeypatch):
    """jax.grad through the balanced replay with the kernel equals jax.grad
    with accel="bvh": the kernel carries no tangents, and u, v are
    recomputed in plain jnp for the triangle it returns."""
    from nart_jax import grad as grad_mod
    from nart_jax import render as render_mod
    from nart_jax import rng as rng_mod
    from nart_jax import sampling
    from tests import scenes

    monkeypatch.setattr(
        pallas_accel, "intersect_pallas",
        functools.partial(pallas_accel.intersect_pallas, interpret=True),
    )
    monkeypatch.setattr(
        pallas_accel, "occluded_pallas",
        functools.partial(pallas_accel.occluded_pallas, interpret=True),
    )
    scene = scenes.simple_scene(("plastic",), roughness=0.4)
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    w = h = 8
    n = w * h
    idx = jnp.arange(n, dtype=jnp.int32)
    state = rng_mod.seed((idx // w) * (w + 2) + idx % w)
    samples, _ = sampling.latin_square(state, 2)
    samples = jnp.swapaxes(samples, 0, 1)
    cot = jnp.ones((2, n, 4)).at[..., 3].set(0.0)
    theta = grad_mod.get_params(scene_j)
    bvh = build_bvh(np.asarray(scene.tri_v))

    out = {}
    for accel in ("bvh", "pallas"):
        params = render_mod.RenderParams(
            image_width=w, image_height=h, spp=2, bounces=3,
            filter_width=1.0, accel=accel,
        )
        loss, grads, _, _ = grad_mod.radiance_weighted_loss_and_grad(
            scene_j, theta, bvh, samples, cot, params, w, h
        )
        out[accel] = (loss, grads)
    np.testing.assert_allclose(float(out["pallas"][0]),
                               float(out["bvh"][0]), rtol=1e-6)
    leaves_p = jax.tree_util.tree_leaves(out["pallas"][1])
    leaves_b = jax.tree_util.tree_leaves(out["bvh"][1])
    assert len(leaves_p) == len(leaves_b) > 0
    for gp, gb in zip(leaves_p, leaves_b):
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gb),
                                   rtol=1e-5, atol=1e-7)
