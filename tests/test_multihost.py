"""Multi-process (multi-host stand-in) execution test.

SURVEY.md §4 / VERDICT r2 #4: spawn 2 OS processes, each with 2 virtual CPU
devices, joined via jax.distributed.initialize on a localhost coordinator —
the standard no-cluster stand-in for a pod slice.  The sharded render and
the gradient psum must match the single-process results exactly (same seeds
=> identical sample decisions; only float association order differs).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from nart_jax import accel, grad as grad_mod
from nart_jax import render as render_mod
from tests import scenes

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_npz(tmp_path_factory):
    """Run the 2-process worker once; returns the rank-0 results."""
    out = str(tmp_path_factory.mktemp("mh") / "rank0.npz")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count (2)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_REPO, "tests", "multihost_worker.py"),
             str(i), "2", coord, out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        logs.append(stdout.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} failed:\n{logs[i]}"
    return np.load(out)


def test_multiprocess_film_matches_single(multihost_npz):
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=10, image_height=6, spp=2, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    single = sess.render()
    np.testing.assert_allclose(
        single, multihost_npz["film"], atol=1e-6, rtol=1e-6
    )


def test_multiprocess_grad_matches_single(multihost_npz):
    import jax.numpy as jnp

    scene = scenes.simple_scene(("lambert",))
    gparams = render_mod.RenderParams(
        image_width=8, image_height=8, spp=1, bounces=2, filter_width=1.0
    )
    bvh = accel.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta0 = grad_mod.get_params(scene_j)
    n = 64
    idx = np.arange(n, dtype=np.int32)
    px, py = jnp.asarray(idx % 8), jnp.asarray(idx // 8)

    def loss(theta):
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

    g_single = jax.grad(loss)(theta0)["rho_d_const"]
    np.testing.assert_allclose(
        np.asarray(g_single), multihost_npz["g_rho"], rtol=1e-5, atol=1e-8
    )
