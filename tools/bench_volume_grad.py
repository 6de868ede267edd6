"""Volume gradient throughput: balanced replay vs lockstep trace_diff.

128^2 @ 8spp on the volume_blob golden scene, on the default device.
"""
import sys
import time

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp
import numpy as np

from nart_jax import grad as grad_mod
from nart_jax import render as render_mod
from nart_jax.scene import load_scene

scene = load_scene("/root/repo/tests/golden/volume_blob.json",
                   asset_root="/root/repo/tests/golden")
W = H = 128
SPP = 8
params = render_mod.RenderParams(
    image_width=W, image_height=H, spp=SPP, bounces=64,
    integrator="volume", filter_width=1.0,
)
scene_j = jax.tree_util.tree_map(jnp.asarray, scene)
n = W * H

# --- lockstep trace_diff path (grad.loss_and_grad/render_lanes)
t0 = time.time()
loss, grads = grad_mod.loss_and_grad(
    scene, params, W, H, SPP, lambda img: jnp.sum(img)
)
print(f"lockstep compile+run: {time.time()-t0:.1f}s", flush=True)
t0 = time.time()
loss, grads = grad_mod.loss_and_grad(
    scene, params, W, H, SPP, lambda img: jnp.sum(img)
)
lock_s = time.time() - t0
print(f"lockstep trace_diff grad: {lock_s:.2f}s", flush=True)

# --- balanced replay path
samples = jnp.zeros((SPP, n, 2))
cot = jnp.ones((SPP, n, 4)).at[..., 3].set(0.0)
theta = grad_mod.get_params(scene_j)
t0 = time.time()
_, _, _, nr = grad_mod.radiance_weighted_loss_and_grad(
    scene_j, theta, None, samples, cot, params, W, H)
print(f"balanced compile+run: {time.time()-t0:.1f}s rounds={nr}", flush=True)
t0 = time.time()
loss_b, grads_b, rays_b, _ = grad_mod.radiance_weighted_loss_and_grad(
    scene_j, theta, None, samples, cot, params, W, H, n_rounds=nr)
bal_s = time.time() - t0
print(f"balanced replay grad: {bal_s:.2f}s  speedup {lock_s/bal_s:.2f}x",
      flush=True)
