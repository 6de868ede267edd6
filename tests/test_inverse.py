"""Inverse rendering: the gradients OPTIMIZE, not just match FD.

Each test renders a target image with known parameters theta*, perturbs a
parameter, and runs a short Adam loop through the balanced path-replay
machinery.  Success = the image loss collapses (>=10x) AND the recovered
parameter lands within a few percent of theta* — the end-to-end property
the FD checks in test_grad.py only proxy (BASELINE.json north star:
"pixel gradients w.r.t. materials/textures/light radiance").

The optimizer sees a FIXED sample set (same RNG streams every step), so
this is deterministic: no flaky MC noise in the assertion.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nart_jax import grad as grad_mod
from nart_jax import render as render_mod
from tests import scenes

W = H = 12
SPP = 4


def _balanced_setup(scene, params):
    n = W * H
    idx = jnp.arange(n, dtype=jnp.int32)
    total_w = W + 2 * int(np.ceil(params.filter_width))
    samples, _ = render_mod._setup_jit(idx % W, idx // W, total_w, SPP)
    scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
    return scene_j, samples, n


def _image(scene_j, theta, samples, params, bvh=None):
    scn = grad_mod.put_params(scene_j, theta)
    la, _, _ = render_mod._trace_balanced_jit(
        samples, scn, bvh, params, W, H, jnp.int32(0)
    )
    return jnp.mean(la[..., :3], axis=0)  # (n, 3)


def _pick(theta, mask):
    """Extract the trainable subset: mask entries are "key" or "key.sub"."""
    out = {}
    for m in mask:
        if "." in m:
            k, sub = m.split(".", 1)
            out.setdefault(k, {})[sub] = theta[k][sub]
        else:
            out[m] = theta[m]
    return out


def _merge(theta, trainable):
    theta = dict(theta)
    for k, v in trainable.items():
        theta[k] = dict(theta[k], **v) if isinstance(v, dict) else v
    return theta


def _optimize(scene_j, theta, target_img, samples, params, mask, bvh=None,
              steps=50, lr=0.1):
    """Adam on the masked theta subset; returns (thetas, losses)."""
    n = target_img.shape[0]
    opt = optax.adam(lr)
    trainable = _pick(theta, mask)
    state = opt.init(trainable)
    losses = []
    n_rounds = None
    for _ in range(steps):
        img = _image(scene_j, theta, samples, params, bvh)
        diff = img - target_img
        loss = float(jnp.mean(diff * diff))
        losses.append(loss)
        # exact linearisation: loss is quadratic in the per-sample mean
        cot_img = 2.0 * diff / np.float32(diff.size)
        cot = jnp.concatenate(
            [
                jnp.broadcast_to(
                    cot_img[None] / np.float32(SPP), (SPP, n, 3)
                ),
                jnp.zeros((SPP, n, 1)),
            ],
            axis=-1,
        )
        _, grads, _, n_rounds = grad_mod.radiance_weighted_loss_and_grad(
            scene_j, theta, bvh, samples, cot, params, W, H,
            n_rounds=n_rounds,
        )
        g = _pick(grads, mask)
        upd, state = opt.update(g, state)
        trainable = optax.apply_updates(trainable, upd)
        theta = _merge(theta, trainable)
    return theta, losses


def test_inverse_albedo_recovers_target():
    """Recover a lambert albedo from the target render: loss drops >=10x
    and the albedo lands within 2% of theta*."""
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=W, image_height=H, spp=SPP, bounces=3, filter_width=1.0
    )
    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    scene_j, samples, n = _balanced_setup(scene, params)

    theta_star = grad_mod.get_params(scene_j)
    target_alb = jnp.full_like(theta_star["rho_d_const"], 0.7)
    theta_star = dict(theta_star, rho_d_const=target_alb)
    target_img = _image(scene_j, theta_star, samples, params, bvh)

    theta0 = dict(theta_star, rho_d_const=jnp.full_like(target_alb, 0.25))
    theta, losses = _optimize(
        scene_j, theta0, target_img, samples, params, ("rho_d_const",),
        bvh=bvh, steps=50, lr=0.05,
    )
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    rec = np.asarray(theta["rho_d_const"])[0]
    np.testing.assert_allclose(rec, 0.7, atol=0.02)


def test_inverse_light_intensity_recovers_target():
    """Recover a disk light's radiance scale (the reference-parity Le is
    per-light constant): loss collapses and Le lands within 3%."""
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=W, image_height=H, spp=SPP, bounces=3, filter_width=1.0
    )
    bvh = grad_mod.build_bvh(np.asarray(scene.tri_v))
    scene_j, samples, n = _balanced_setup(scene, params)

    theta_star = grad_mod.get_params(scene_j)
    le_star = [jnp.asarray(le) * 1.5 for le in theta_star["light_le"]]
    theta_star = dict(theta_star, light_le=le_star)
    target_img = _image(scene_j, theta_star, samples, params, bvh)

    theta0 = dict(
        theta_star, light_le=[jnp.asarray(le) * 0.4 for le in le_star]
    )
    theta, losses = _optimize(
        scene_j, theta0, target_img, samples, params, ("light_le",),
        bvh=bvh, steps=80, lr=0.25,
    )
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    rec = np.asarray(theta["light_le"][0])
    np.testing.assert_allclose(rec, np.asarray(le_star[0]), rtol=0.04)


def test_inverse_volume_emission_recovers_target():
    """Recover a medium's emission Le through the balanced volume replay."""
    from nart_jax.scene import LIGHT_ENV, LightData, MediumData

    base = scenes.simple_scene(("lambert",))
    medium = MediumData(
        bounds_min=np.float32([-1, -1, -1]),
        bounds_max=np.float32([1, 1, 1]),
        sigma_a=np.float32(0.8), sigma_s=np.float32(0.0),
        le=np.float32([2.0, 2.0, 2.0]),
        density=np.ones((4, 4, 4), np.float32),
        sigma_maj=0.8,
    )
    light = LightData(
        kind=LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=np.float32(0.0),
        le_const=np.zeros(3, np.float32), le_tex=None, env2d=None,
    )
    scene = dataclasses.replace(base, lights=[light], medium=medium)
    params = render_mod.RenderParams(
        image_width=W, image_height=H, spp=SPP, bounces=16,
        integrator="volume", filter_width=1.0,
    )
    scene_j, samples, n = _balanced_setup(scene, params)

    theta_star = grad_mod.get_params(scene_j)
    target_img = _image(scene_j, theta_star, samples, params)

    theta0 = dict(theta_star)
    theta0["medium"] = dict(
        theta_star["medium"], le=jnp.asarray([0.6, 0.6, 0.6], jnp.float32)
    )
    theta, losses = _optimize(
        scene_j, theta0, target_img, samples, params, ("medium.le",),
        steps=80, lr=0.3,
    )
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    rec = np.asarray(theta["medium"]["le"])
    np.testing.assert_allclose(rec, 2.0, rtol=0.05)
