"""Film tests: dense grid splat == scatter splat (same tap weights)."""

import numpy as np
import jax.numpy as jnp

from nart_jax import film


def test_splat_grid_matches_scatter():
    g = np.random.default_rng(0)
    for fw, rw, rh in ((1.0, 8, 6), (2.0, 16, 16), (1.5, 5, 7), (3.0, 4, 4)):
        fb = int(np.ceil(fw))
        tw, th = rw + 2 * fb, rh + 2 * fb
        n = rw * rh
        jit = g.random((n, 2), dtype=np.float32)
        la = g.random((n, 4), dtype=np.float32)
        idx = np.arange(n)
        px, py = idx % rw, idx // rw
        coords = np.stack([px + fb + jit[:, 0], py + fb + jit[:, 1]], -1)
        table = jnp.asarray(film.filter_table())
        f0 = jnp.zeros((th, tw, 5))
        a = film.splat(f0, jnp.asarray(coords), jnp.asarray(la), fw, table)
        b = film.splat_grid(
            f0, jnp.asarray(jit), jnp.asarray(la), fw, table, rw, rh, fb
        )
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_splat_grid_drops_out_of_film_taps():
    # render_h == total_h (bucket-clamp case): bottom-row taps run off the
    # film and must be discarded, as the reference's merge does
    fw, rw = 1.0, 4
    fb = 1
    rh = 6  # == total_h for image_height 4
    th, tw = rh, rw + 2 * fb
    n = rw * rh
    g = np.random.default_rng(1)
    jit = g.random((n, 2), dtype=np.float32)
    la = np.ones((n, 4), np.float32)
    table = jnp.asarray(film.filter_table())
    f0 = jnp.zeros((th, tw, 5))
    b = film.splat_grid(
        f0, jnp.asarray(jit), jnp.asarray(la), fw, table, rw, rh, fb
    )
    assert np.isfinite(np.asarray(b)).all()
    assert b.shape == (th, tw, 5)
