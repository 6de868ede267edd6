"""Sharding invariance: same seed => bit-identical image across device counts."""

import jax
import numpy as np
import pytest

from nart_jax import accel
from nart_jax import render as render_mod
from nart_jax import sharding
from tests import scenes


def _film_sharded(scene, params, n_dev):
    sess = render_mod.RenderSession(scene, params)
    mesh = sharding.make_mesh(n_dev)
    out = sharding.render_sharded(
        scene, sess.bvh, params, mesh,
        sess.render_w, sess.render_h, sess.total_w, sess.total_h,
        sess.filter_bounds,
    )
    return np.asarray(out)


def test_sharded_matches_single_chip():
    assert len(jax.devices()) >= 8, "conftest should give 8 virtual devices"
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=10, image_height=6, spp=2, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    single = sess.render()
    for n_dev in (2, 8):  # 60 lanes % 8 != 0: exercises lane padding
        multi = _film_sharded(scene, params, n_dev)
        # identical sample decisions; only film-sum association differs
        np.testing.assert_allclose(single, multi, atol=1e-6, rtol=1e-6)


def test_sharded_2d_spp_axis_matches_single_chip():
    """2-D (rows x spp) mesh: per-item RNG streams are keyed by global
    (pixel, sample) ids, so the image is invariant to BOTH axes' shapes.
    spp=3 on a 2-wide spp axis exercises the sample-slab padding."""
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=10, image_height=6, spp=3, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    single = sess.render()
    for n_tiles, n_spp in ((2, 2), (4, 2), (1, 3)):
        mesh = sharding.make_mesh2(n_tiles, n_spp)
        out = np.asarray(
            sharding.render_sharded(
                scene, sess.bvh, params, mesh,
                sess.render_w, sess.render_h, sess.total_w, sess.total_h,
                sess.filter_bounds,
            )
        )
        np.testing.assert_allclose(single, out, atol=1e-6, rtol=1e-6)


def test_sharded_gradient_allreduce():
    # grads of a sharded render w.r.t. replicated params match single-device
    import functools

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from nart_jax import grad as grad_mod

    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=1, bounces=2, filter_width=1.0
    )
    bvh = accel.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta0 = grad_mod.get_params(scene_j)
    mesh = sharding.make_mesh(4)
    n = 64
    idx = np.arange(n, dtype=np.int32)
    px, py = idx % 8, idx // 8

    def lanes_loss(theta, px, py):
        scn = grad_mod.put_params(scene_j, theta)
        lanes = _trace_lanes(scn, bvh, params, px, py)
        return jnp.sum(lanes)

    def _trace_lanes(scn, bvh, params, px, py):
        from nart_jax import camera, rng, sampling
        from nart_jax.integrators import path as pi

        state = rng.seed(py * 8 + px)
        samples, state = sampling.latin_square(state, params.spp)
        o, d = camera.cast_rays(
            scn.cam_to_world, scn.fov, 8, 8, px, py, samples[:, 0]
        )
        l, a, _, _ = pi.trace(scn, bvh, o, d, state, params, differentiable=True)
        return l

    g_single = jax.grad(lambda t: lanes_loss(t, jnp.asarray(px), jnp.asarray(py)))(theta0)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P("tiles"), P("tiles")), out_specs=P(),
        check_vma=False,
    )
    def sharded_loss(theta, px, py):
        return jax.lax.psum(lanes_loss(theta, px, py), "tiles")

    g_multi = jax.grad(
        lambda t: sharded_loss(t, jnp.asarray(px), jnp.asarray(py))
    )(theta0)
    for k in ("rho_d_const",):
        np.testing.assert_allclose(
            np.asarray(g_single[k]), np.asarray(g_multi[k]), rtol=1e-5
        )


@pytest.mark.parametrize("n_tiles,n_spp", [(2, 2), (4, 1)])
def test_sharded_replay_step_matches_one_device(n_tiles, n_spp):
    """The sharded fwd+bwd step (sharding.sharded_replay_step, the path
    chip_smoke.py --cards 4 runs on four cards) gives the one-device loss
    and gradients: per-item streams are keyed by global ids, only the
    summation order differs."""
    import jax.numpy as jnp

    from nart_jax import grad as grad_mod

    scene = scenes.simple_scene(("plastic", "lambert"), roughness=0.3)
    params = render_mod.RenderParams(
        image_width=8, image_height=6, spp=3, bounces=3, filter_width=1.0
    )
    bvh = accel.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta = grad_mod.get_params(scene_j)
    def step(mesh):
        n_rounds = sharding.sharded_replay_rounds(
            scene_j, bvh, theta, params, mesh, 8, 6
        )
        (loss, unfinished), grads = sharding.sharded_replay_step(
            scene_j, bvh, params, mesh, 8, 6, n_rounds
        )(theta)
        assert int(unfinished) == 0
        return loss, grads

    one = step(sharding.make_mesh2(1, 1))
    many = step(sharding.make_mesh2(n_tiles, n_spp))
    np.testing.assert_allclose(float(many[0]), float(one[0]), rtol=1e-5)
    for g1, gn in zip(jax.tree_util.tree_leaves(one[1]),
                      jax.tree_util.tree_leaves(many[1])):
        np.testing.assert_allclose(np.asarray(gn), np.asarray(g1),
                                   rtol=1e-4, atol=1e-6)
