"""Distribution tests for sampling warps: ranges, pdfs, chi-square."""

import jax.numpy as jnp
import numpy as np

from nart_jax import sampling


def _u2(n, seed=0):
    g = np.random.default_rng(seed)
    return jnp.asarray(g.random((n, 2), dtype=np.float32))


def test_disk_in_unit_disk():
    xy = np.array(sampling.uniform_sample_disk(_u2(4096)))
    r2 = (xy**2).sum(-1)
    assert (r2 <= 1.0 + 1e-6).all()
    # uniform: E[r^2] = 1/2
    assert abs(r2.mean() - 0.5) < 0.02


def test_ring_radius_bounds():
    inner = 0.25
    xy, pdf = sampling.uniform_sample_ring(_u2(4096), np.float32(inner))
    r2 = (np.array(xy) ** 2).sum(-1)
    # reference mixes inner (not inner^2) into r^2: r in [sqrt(inner), 1]
    assert (r2 >= inner - 1e-5).all() and (r2 <= 1.0 + 1e-5).all()
    np.testing.assert_allclose(
        np.array(pdf), 1.0 / (np.pi * (1 - inner)), rtol=1e-6
    )


def test_sphere_uniform():
    w, pdf = sampling.uniform_sample_sphere(_u2(8192))
    w = np.array(w)
    np.testing.assert_allclose(np.linalg.norm(w, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.array(pdf), 1.0 / (4 * np.pi), rtol=1e-6)
    # each octant gets ~1/8 of samples (chi-square, 7 dof, alpha≈1e-3)
    octant = (w[:, 0] > 0) * 4 + (w[:, 1] > 0) * 2 + (w[:, 2] > 0)
    counts = np.bincount(octant, minlength=8)
    expected = len(w) / 8
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 24.3


def test_cosine_hemisphere():
    w, pdf = sampling.cosine_sample_hemisphere(_u2(8192))
    w, pdf = np.array(w), np.array(pdf)
    assert (w[:, 2] >= 0).all()
    np.testing.assert_allclose(pdf, w[:, 2] / np.pi, atol=1e-6)
    # E[cos theta] = integral cos^2/pi over hemisphere = 2/3
    assert abs(w[:, 2].mean() - 2.0 / 3.0) < 0.01


def test_exponential_decay():
    u = jnp.asarray(np.random.default_rng(0).random(8192, dtype=np.float32))
    t = np.array(sampling.sample_exponential_decay(u, np.float32(2.0)))
    assert (t >= 0).all()
    assert abs(t.mean() - 0.5) < 0.02  # mean = 1/a
