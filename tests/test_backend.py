"""Rules that keep the program right on the GPU, checked on the CPU.

  * every f32 matrix product of the render and of its replay backward is
    pinned to full precision (a GPU may otherwise run it in TF32);
  * the traversal chosen for a backend is never the Pallas interpreter;
  * the compile cache honours JAX_COMPILATION_CACHE_DIR and otherwise
    stays inside the checkout.
"""

import os
import subprocess
import sys

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

import nart_jax
from nart_jax import accel as accel_mod
from nart_jax import pallas_accel, render as render_mod, rng, sampling
from nart_jax.integrators import path as path_integrator
from nart_jax.scene import load_scene

HERE = os.path.dirname(__file__)
REPO = os.path.dirname(HERE)
MACBETH = os.path.join(HERE, "fixtures", "macbeth")


def _scene(name):
    if name == "macbeth":  # env light with a texture, textured plastic
        return load_scene(os.path.join(MACBETH, "macbeth.json"),
                          asset_root=MACBETH)
    # cornell: lambert walls under a disk light (the packed-light path)
    return load_scene(os.path.join(HERE, "golden", "cornell.json"),
                      asset_root=MACBETH)


def _balanced_inputs(scene, w=8, h=8, spp=2):
    n = w * h
    idx = jnp.arange(n, dtype=jnp.int32)
    state = rng.seed((idx // w) * (w + 4) + idx % w)
    samples, _ = sampling.latin_square(state, spp)
    samples = jnp.swapaxes(samples, 0, 1)
    params = render_mod.RenderParams(
        image_width=w, image_height=h, spp=spp, bounces=4,
        filter_width=2.0, roughening_factor=0.5, accel="bvh",
    )
    bvh = accel_mod.build_bvh(np.asarray(scene.tri_v))
    scene = jax.tree_util.tree_map(jnp.asarray, scene)
    return scene, bvh, samples, params


def _sub_jaxprs(params):
    for v in params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def _loose_dots(jaxpr):
    """f32 dot_generals whose precision is not HIGHEST, in all sub-jaxprs."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            f32 = any(v.aval.dtype == jnp.float32 for v in eqn.invars)
            prec = eqn.params.get("precision")
            pinned = prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in prec
            )
            if f32 and not pinned:
                bad.append(str(eqn)[:160])
        for sub in _sub_jaxprs(eqn.params):
            bad += _loose_dots(sub)
    return bad


@pytest.mark.parametrize("scene_name", ["macbeth", "cornell"])
@pytest.mark.parametrize("fn", ["trace_balanced", "trace_balanced_loss"])
def test_f32_dots_are_pinned_to_highest(fn, scene_name):
    scene, bvh, samples, params = _balanced_inputs(_scene(scene_name))
    w, h = params.image_width, params.image_height
    if fn == "trace_balanced":
        def f(scene):
            return path_integrator.trace_balanced(
                scene, bvh, samples, params, w, h
            )[0]
    else:
        from nart_jax import grad as grad_mod

        cot = jnp.ones(samples.shape[:2] + (4,))

        def f(scene):
            def loss(theta):
                scn = grad_mod.put_params(scene, theta)
                return path_integrator.trace_balanced_loss(
                    scn, bvh, samples, cot, params, w, h, 8
                )[0]

            return jax.grad(loss)(grad_mod.get_params(scene))

    jaxpr = jax.make_jaxpr(f)(scene).jaxpr
    bad = _loose_dots(jaxpr)
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("backend", ["gpu", "cuda", "rocm", "metal", "cpu"])
def test_auto_accel_is_never_interpreted(backend, monkeypatch):
    """'auto' picks the compiled kernel on a GPU and the plain lockstep walk
    elsewhere, and the integrator never asks the kernel for interpret
    mode."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    kind = accel_mod.resolve_accel_kind("auto")
    assert kind == ("pallas" if backend == "gpu" else "bvh")
    assert accel_mod.resolve_accel_kind("brute") == "brute"
    if kind != "pallas":
        return
    seen = []

    def spy(o, d, t_min, t_max, bvh, any_hit, interpret):
        seen.append(interpret)
        n = o.shape[0]
        return jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32)

    monkeypatch.setattr(pallas_accel, "_walk", spy)
    scene, bvh, samples, params = _balanced_inputs(_scene("cornell"))
    params = render_mod.RenderParams(**{**params.__dict__, "accel": kind})
    jax.make_jaxpr(
        lambda s: path_integrator.trace_balanced(
            s, bvh, samples, params, 8, 8
        )[0]
    )(scene)
    assert seen and not any(seen)


def test_default_compile_cache_is_inside_checkout():
    path = nart_jax.compile_cache_dir()
    assert os.path.commonpath([path, REPO]) == REPO
    assert path.startswith(os.path.join(REPO, ".jax_cache") + os.sep)
    assert path == nart_jax.compile_cache_dir()  # stable: no pid or time


def test_compile_cache_config_in_this_process():
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    want = env if env else nart_jax.compile_cache_dir()
    assert jax.config.jax_compilation_cache_dir == want


def test_compile_cache_env_var_is_honoured(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, nart_jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    ).stdout.strip().splitlines()[-1]
    assert out == str(tmp_path / "cc")
