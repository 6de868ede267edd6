"""Worker for tests/test_multihost.py: one rank of a 2-process CPU render.

Run as:  python tests/multihost_worker.py <process_id> <num_processes>
             <coordinator> <out.npz>

Each process brings 2 virtual CPU devices, so the global mesh spans
num_processes * 2 devices across OS processes — the standard no-cluster
stand-in for a multi-host pod slice (SURVEY.md §4): same
jax.distributed.initialize + global-mesh shard_map code path as real
multi-host, with DCN collectives exercised across process boundaries.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    proc_id, n_proc = int(sys.argv[1]), int(sys.argv[2])
    coordinator, out_path = sys.argv[3], sys.argv[4]
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=n_proc,
        process_id=proc_id,
    )
    assert jax.process_count() == n_proc
    assert len(jax.devices()) == 2 * n_proc  # global view on every rank

    import functools

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from nart_jax import accel, grad as grad_mod
    from nart_jax import render as render_mod, sharding
    from nart_jax.testing import simple_scene

    scene = simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=10, image_height=6, spp=2, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    mesh = sharding.make_mesh()  # all 2*n_proc devices, both processes
    film = sharding.render_sharded(
        scene, sess.bvh, params, mesh,
        sess.render_w, sess.render_h, sess.total_w, sess.total_h,
        sess.filter_bounds,
    )
    film_np = np.asarray(film)  # replicated output: readable on every rank

    # parameter gradient with the cross-process psum all-reduce
    bvh = accel.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta0 = grad_mod.get_params(scene_j)
    n = 64
    idx = np.arange(n, dtype=np.int32)
    px, py = (idx % 8).astype(np.int32), (idx // 8).astype(np.int32)
    gparams = render_mod.RenderParams(
        image_width=8, image_height=8, spp=1, bounces=2, filter_width=1.0
    )

    def lanes_loss(theta, px, py):
        from nart_jax import camera, rng, sampling
        from nart_jax.integrators import path as pi

        scn = grad_mod.put_params(scene_j, theta)
        state = rng.seed(py * 8 + px)
        samples, state = sampling.latin_square(state, gparams.spp)
        o, d = camera.cast_rays(
            scn.cam_to_world, scn.fov, 8, 8, px, py, samples[:, 0]
        )
        l, a, _, _ = pi.trace(scn, bvh, o, d, state, gparams,
                              differentiable=True)
        return jnp.sum(l)

    axis = mesh.axis_names[0]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)), out_specs=P(),
        check_vma=False,
    )
    def sharded_loss(theta, px, py):
        return jax.lax.psum(lanes_loss(theta, px, py), axis)

    theta_put = sharding._put(mesh, theta0, P())
    g = jax.grad(
        lambda t: sharded_loss(
            t,
            sharding._put(mesh, px, P(axis)),
            sharding._put(mesh, py, P(axis)),
        )
    )(theta_put)
    g_rho = np.asarray(g["rho_d_const"])

    if sharding.is_primary():
        np.savez(out_path, film=film_np, g_rho=g_rho)
    # all ranks must stay alive until rank 0 finishes its transfers
    jax.block_until_ready(film)
    print(f"rank {proc_id}: ok", flush=True)


if __name__ == "__main__":
    main()
