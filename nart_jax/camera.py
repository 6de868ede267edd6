"""Pinhole camera ray generation.  Parity: src/cameras/pinholecamera.cpp.

Note the reference treats "fov" as a half-angle in degrees and applies the
aspect ratio on x only; camera-space direction is normalised *before* the
world transform and not renormalised after (pinholecamera.cpp:9-40).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def cast_rays(cam_to_world, fov_deg, width, height, px, py, image_sample):
    """Generate world-space rays for pixel coords (px, py) + jitter.

    Args:
      cam_to_world: (4,4) row-major matrix A (points transform as A @ [p,1]).
      fov_deg: static float (half-angle, degrees).
      width/height: static ints (the *image* dims used for NDC mapping).
      px, py: (N,) int32 pixel coords.
      image_sample: (N, 2) jitter in [0,1).
    Returns (o, d): (N,3) origins and (unnormalised-after-transform) dirs.
    """
    a = jnp.asarray(cam_to_world)
    tan_fov = np.float32(np.tan(np.radians(np.float32(fov_deg))))
    aspect = np.float32(width / height)
    x = (
        ((px.astype(jnp.float32) + image_sample[..., 0]) / np.float32(width))
        * 2.0
        - 1.0
    ) * tan_fov * aspect
    y = (
        ((py.astype(jnp.float32) + image_sample[..., 1]) / np.float32(height))
        * -2.0
        + 1.0
    ) * tan_fov
    d_cam = jnp.stack([x, y, -jnp.ones_like(x)], axis=-1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    o = jnp.broadcast_to(a[:3, 3], d_cam.shape)
    d = jnp.matmul(d_cam, a[:3, :3].T, precision=jax.lax.Precision.HIGHEST)
    return o, d
