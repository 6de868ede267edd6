"""Gradient validation: detached-estimator autodiff vs finite differences.

Finite differences through a Monte Carlo renderer only match autodiff when
the random stream (and thus every sampling decision) is common between the
two evaluations — which our deterministic counter-based streams guarantee.
For parameters that do not influence any discrete decision (albedo, light
radiance), FD and AD then agree to first order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nart_jax import grad as grad_mod
from nart_jax import render as render_mod
from tests import scenes


def _setup(materials=("lambert",), **kw):
    scene = scenes.simple_scene(materials, **kw)
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=2, bounces=3, filter_width=1.0
    )
    return scene, params


def _fd_check(scene, params, field, eps, rtol, component=(0, 0)):
    loss_fn = lambda img: jnp.sum(img)
    loss, grads = grad_mod.loss_and_grad(
        scene, params, params.image_width, params.image_height, params.spp,
        loss_fn,
    )
    g_ad = np.asarray(grads[field])[component]

    theta = grad_mod.get_params(scene)
    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))

    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)

    def eval_loss(theta):
        scn = grad_mod.put_params(scene_j, theta)
        lanes = grad_mod.render_lanes(
            scn, bvh, params, params.image_width, params.image_height,
            params.spp,
        )
        return float(jnp.sum(lanes))

    tp = jax.tree_util.tree_map(lambda x: np.array(x, np.float64), theta)
    tp[field][component] += eps
    tp = {k: (jnp.asarray(np.float32(v)) if not isinstance(v, list) else v)
          for k, v in tp.items()}
    up = eval_loss(tp)
    tm = jax.tree_util.tree_map(lambda x: np.array(x, np.float64), theta)
    tm[field][component] -= eps
    tm = {k: (jnp.asarray(np.float32(v)) if not isinstance(v, list) else v)
          for k, v in tm.items()}
    down = eval_loss(tm)
    g_fd = (up - down) / (2 * eps)
    assert abs(g_ad - g_fd) <= rtol * max(abs(g_fd), 1e-3), (g_ad, g_fd)
    return g_ad, g_fd


def test_albedo_gradient_matches_fd():
    scene, params = _setup(("lambert",))
    g_ad, g_fd = _fd_check(scene, params, "rho_d_const", eps=1e-2, rtol=0.05)
    assert g_fd > 0  # brighter albedo -> brighter image


def test_light_radiance_gradient_matches_fd():
    scene, params = _setup(("lambert",))
    loss_fn = lambda img: jnp.sum(img)
    loss, grads = grad_mod.loss_and_grad(
        scene, params, params.image_width, params.image_height, params.spp,
        loss_fn,
    )
    g_ad = np.asarray(grads["light_le"][0])

    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    eps = 1e-2

    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)

    def eval_at(delta):
        li = dataclasses.replace(
            scene_j.lights[0],
            le_const=scene_j.lights[0].le_const + np.float32(delta),
        )
        scn = dataclasses.replace(scene_j, lights=[li])
        lanes = grad_mod.render_lanes(
            scn, bvh, params, params.image_width, params.image_height,
            params.spp,
        )
        return float(jnp.sum(lanes))

    g_fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
    assert abs(g_ad.sum() - g_fd) <= 0.05 * max(abs(g_fd), 1e-3), (
        g_ad.sum(), g_fd,
    )
    assert g_fd > 0


def test_balanced_gradient_matches_fd():
    """Path-replay backprop over the balanced work-queue wavefront: AD of
    the cotangent-weighted radiance sum matches finite differences of the
    same (deterministic, per-item-stream) forward estimator."""
    from nart_jax import rng, sampling
    from nart_jax.integrators import path as path_integrator

    scene, params = _setup(("lambert",))
    w = h = params.image_width
    n = w * h
    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)

    idx = jnp.arange(n, dtype=jnp.int32)
    px, py = idx % w, idx // w
    state = rng.seed(py * (w + 2) + px)
    samples, _ = sampling.latin_square(state, params.spp)
    samples = jnp.swapaxes(samples, 0, 1)
    cot = jnp.ones((params.spp, n, 4)).at[..., 3].set(0.0)

    theta = grad_mod.get_params(scene_j)
    loss, grads, rays, _ = grad_mod.radiance_weighted_loss_and_grad(
        scene_j, theta, bvh, samples, cot, params, w, h
    )
    g_ad = np.asarray(grads["rho_d_const"])[0, 0]

    @jax.jit
    def fwd_loss(theta):
        scn = grad_mod.put_params(scene_j, theta)
        la, _, _ = path_integrator.trace_balanced(
            scn, bvh, samples, params, w, h
        )
        return jnp.sum(la[..., :3])

    # AD loss equals the forward estimator exactly (same replayed paths)
    np.testing.assert_allclose(float(loss), float(fwd_loss(theta)), rtol=1e-5)

    eps = 1e-2
    tp = jax.tree_util.tree_map(lambda x: np.array(x, np.float64), theta)
    tp["rho_d_const"][0, 0] += eps
    tp = {k: (jnp.asarray(np.float32(v)) if not isinstance(v, list) else v)
          for k, v in tp.items()}
    tm = jax.tree_util.tree_map(lambda x: np.array(x, np.float64), theta)
    tm["rho_d_const"][0, 0] -= eps
    tm = {k: (jnp.asarray(np.float32(v)) if not isinstance(v, list) else v)
          for k, v in tm.items()}
    g_fd = (float(fwd_loss(tp)) - float(fwd_loss(tm))) / (2 * eps)
    assert abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), 1e-3), (g_ad, g_fd)
    assert g_fd > 0


def test_roughness_gradient_finite():
    # glossy roughness influences f and D; decisions detached — gradient
    # must exist and be finite (FD is noisier here; check well-defined only)
    scene, params = _setup(("glossy",), roughness=0.4)
    loss_fn = lambda img: jnp.sum(img)
    loss, grads = grad_mod.loss_and_grad(
        scene, params, params.image_width, params.image_height, params.spp,
        loss_fn,
    )
    g = np.asarray(grads["alpha_const"])
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_env_radiance_gradient_matches_fd():
    """North star: gradients w.r.t. light radiance TEXTURES (env map) and
    the scalar intensity.  env2d=None (uniform sampling) keeps pdfs
    independent of the texture, so FD of the same deterministic estimator
    matches AD to first order.  Reference semantics:
    environmentlight.cpp:9-79 + texturepattern.cpp:131-155."""
    from nart_jax.testing import env_scene

    scene = env_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=2, bounces=3, filter_width=1.0
    )
    loss_fn = lambda img: jnp.sum(img)
    loss, grads = grad_mod.loss_and_grad(
        scene, params, params.image_width, params.image_height, params.spp,
        loss_fn,
    )
    g_tex = np.asarray(grads["light_le_tex"][0])
    g_int = float(np.asarray(grads["light_intensity"][0]))
    assert np.isfinite(g_tex).all() and g_tex.shape == (4, 8, 3)
    assert np.abs(g_tex).sum() > 0 and g_int > 0

    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta = grad_mod.get_params(scene_j)

    def eval_loss(th):
        scn = grad_mod.put_params(scene_j, th)
        lanes = grad_mod.render_lanes(
            scn, bvh, params, params.image_width, params.image_height,
            params.spp,
        )
        return float(jnp.sum(lanes))

    # FD on one bright texel that the AD gradient says is in use
    ij = np.unravel_index(np.argmax(np.abs(g_tex)), g_tex.shape)
    eps = 1e-2
    for sign in (+1, -1):
        tex = np.array(theta["light_le_tex"][0], np.float64)
        tex[ij] += sign * eps
        th = dict(theta)
        th["light_le_tex"] = [jnp.asarray(np.float32(tex))]
        if sign > 0:
            up = eval_loss(th)
        else:
            down = eval_loss(th)
    g_fd = (up - down) / (2 * eps)
    assert abs(g_tex[ij] - g_fd) <= 0.05 * max(abs(g_fd), 1e-3), (
        g_tex[ij], g_fd,
    )

    # FD on the intensity scalar
    for sign in (+1, -1):
        th = dict(theta)
        th["light_intensity"] = [
            jnp.asarray(np.float32(float(theta["light_intensity"][0])
                                   + sign * eps))
        ]
        if sign > 0:
            up = eval_loss(th)
        else:
            down = eval_loss(th)
    g_fd_int = (up - down) / (2 * eps)
    assert abs(g_int - g_fd_int) <= 0.05 * max(abs(g_fd_int), 1e-3), (
        g_int, g_fd_int,
    )


def test_balanced_training_survives_theta_drift():
    """Round counts depend on theta (lobe choices sample u < fresnel(eta),
    RR thresholds beta); a training loop that caches n_rounds across
    optimizer steps must not crash when theta drifts past the cached count
    — radiance_weighted_loss_and_grad re-measures and regrows instead
    (VERDICT r3 weak #5)."""
    from nart_jax import rng, sampling

    scene, params = _setup(("glass", "lambert"), priorities=[1, 0])
    w = h = params.image_width
    n = w * h
    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)

    idx = jnp.arange(n, dtype=jnp.int32)
    px, py = idx % w, idx // w
    state = rng.seed(py * (w + 2) + px)
    samples, _ = sampling.latin_square(state, params.spp)
    samples = jnp.swapaxes(samples, 0, 1)
    cot = jnp.ones((params.spp, n, 4)).at[..., 3].set(0.0)

    theta = grad_mod.get_params(scene_j)
    n_rounds = None
    losses = []
    for step in range(3):
        loss, grads, rays, n_rounds = grad_mod.radiance_weighted_loss_and_grad(
            scene_j, theta, bvh, samples, cot, params, w, h,
            n_rounds=n_rounds,
        )
        losses.append(float(loss))
        assert np.isfinite(losses[-1])
        # aggressive eta/albedo update: flips fresnel lobe decisions and
        # with them the per-chunk round count
        theta = dict(theta)
        theta["eta_const"] = theta["eta_const"] + 0.4
        theta["rho_d_const"] = theta["rho_d_const"] * 0.7
    assert len(set(losses)) == 3  # the updates actually changed the loss


def test_volume_balanced_gradient_matches_fd():
    """Differentiable work-queue volume transport (volume
    trace_balanced_loss via radiance_weighted_loss_and_grad): the AD
    gradient of the cotangent-weighted radiance matches finite
    differences for medium Le (which influences no sampling decision), and
    the AD loss equals the forward estimator exactly."""
    import dataclasses

    from nart_jax.integrators import volume as vol_int
    from nart_jax.scene import LIGHT_ENV, LightData, MediumData

    base = scenes.simple_scene(("lambert",))
    dens = np.ones((4, 4, 4), np.float32)
    medium = MediumData(
        bounds_min=np.float32([-1, -1, -1]),
        bounds_max=np.float32([1, 1, 1]),
        sigma_a=np.float32(0.8), sigma_s=np.float32(0.0),
        le=np.float32([2.0, 2.0, 2.0]), density=dens,
        sigma_maj=0.8,
    )
    light = LightData(
        kind=LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=np.float32(0.0),
        le_const=np.zeros(3, np.float32), le_tex=None, env2d=None,
    )
    scene = dataclasses.replace(base, lights=[light], medium=medium)
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=4, bounces=16,
        integrator="volume", filter_width=1.0,
    )
    w = h = params.image_width
    n = w * h
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    samples = jnp.zeros((params.spp, n, 2))
    cot = jnp.ones((params.spp, n, 4)).at[..., 3].set(0.0)

    theta = grad_mod.get_params(scene_j)
    loss, grads, rays, _ = grad_mod.radiance_weighted_loss_and_grad(
        scene_j, theta, None, samples, cot, params, w, h
    )

    def fwd_loss(theta):
        scn = grad_mod.put_params(scene_j, theta)
        la, _, _ = vol_int.trace_balanced(scn, None, samples, params, w, h)
        return float(jnp.sum(la[..., :3]))

    np.testing.assert_allclose(float(loss), fwd_loss(theta), rtol=1e-5)

    eps = 1e-2
    up = dict(theta); up["medium"] = dict(theta["medium"])
    up["medium"]["le"] = theta["medium"]["le"] + eps
    dn = dict(theta); dn["medium"] = dict(theta["medium"])
    dn["medium"]["le"] = theta["medium"]["le"] - eps
    g_fd = (fwd_loss(up) - fwd_loss(dn)) / (2 * eps)
    g_ad = float(np.asarray(grads["medium"]["le"]).sum())
    np.testing.assert_allclose(g_ad, g_fd, rtol=1e-3)
    # sigma_a gradient exists and is positive (pure emission medium)
    assert float(grads["medium"]["sigma_a"]) > 0


def test_volume_loss_and_grad_balanced_matches_fd():
    """The image-loss convenience entry (loss_and_grad) routes volume
    scenes through the balanced replay machine by default — verify its
    gradient against finite differences of the SAME balanced estimator
    (medium Le influences no sampling decision, so FD and AD agree to
    first order)."""
    import dataclasses

    from nart_jax.scene import LIGHT_ENV, LightData, MediumData

    base = scenes.simple_scene(("lambert",))
    dens = np.ones((4, 4, 4), np.float32)
    medium = MediumData(
        bounds_min=np.float32([-1, -1, -1]),
        bounds_max=np.float32([1, 1, 1]),
        sigma_a=np.float32(0.8), sigma_s=np.float32(0.0),
        le=np.float32([2.0, 2.0, 2.0]), density=dens,
        sigma_maj=0.8,
    )
    light = LightData(
        kind=LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=np.float32(0.0),
        le_const=np.zeros(3, np.float32), le_tex=None, env2d=None,
    )
    scene = dataclasses.replace(base, lights=[light], medium=medium)
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=4, bounces=16,
        integrator="volume", filter_width=1.0,
    )
    w = h = params.image_width

    loss_fn = lambda img: jnp.sum(img)
    loss, grads = grad_mod.loss_and_grad(scene, params, w, h, params.spp,
                                         loss_fn)

    # FD through the identical balanced forward (spp-mean image)
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    theta = grad_mod.get_params(scene_j)
    n = w * h
    idx = jnp.arange(n, dtype=jnp.int32)
    total_w = w + 2 * int(np.ceil(params.filter_width))
    samples, _ = render_mod._setup_jit(idx % w, idx // w, total_w,
                                       params.spp)

    def fwd_loss(th):
        scn = grad_mod.put_params(scene_j, th)
        la, _, _ = render_mod._trace_balanced_jit(
            samples, scn, None, params, w, h, jnp.int32(0)
        )
        return float(jnp.sum(jnp.mean(la[..., :3], axis=0)))

    np.testing.assert_allclose(float(loss), fwd_loss(theta), rtol=1e-5)

    eps = 1e-2
    up = dict(theta); up["medium"] = dict(theta["medium"])
    up["medium"]["le"] = theta["medium"]["le"] + eps
    dn = dict(theta); dn["medium"] = dict(theta["medium"])
    dn["medium"]["le"] = theta["medium"]["le"] - eps
    g_fd = (fwd_loss(up) - fwd_loss(dn)) / (2 * eps)
    g_ad = float(np.asarray(grads["medium"]["le"]).sum())
    np.testing.assert_allclose(g_ad, g_fd, rtol=1e-3)
