"""RNG parity tests: jnp implementation vs scalar transcription of rng.h."""

import jax.numpy as jnp
import numpy as np

from nart_jax import rng, sampling


def test_uniform_float_matches_scalar():
    for s in [0, 1, 7, 123456, 2**31, 2**32 - 1]:
        sc = rng.ScalarRNG()
        sc.seed(s)
        want = [sc.uniform_float() for _ in range(32)]

        y = rng.seed(jnp.array([s], dtype=jnp.uint32))
        got = []
        for _ in range(32):
            f, y = rng.next_float(y)
            got.append(float(f[0]))
        np.testing.assert_array_equal(np.float32(want), np.float32(got))


def test_uniform_int32_matches_scalar():
    sc = rng.ScalarRNG()
    sc.seed(42)
    want = [sc.uniform_int32(m) for m in [0, 1, 5, 63, 1023, 9999]]

    y = rng.seed(jnp.array([42], dtype=jnp.uint32))
    got = []
    for m in [0, 1, 5, 63, 1023, 9999]:
        v, y = rng.next_int32(y, jnp.uint32(m))
        got.append(int(v[0]))
    assert want == got
    for v, m in zip(got, [0, 1, 5, 63, 1023, 9999]):
        assert 0 <= v <= m


def test_masked_draw_preserves_state():
    y0 = rng.seed(jnp.arange(4, dtype=jnp.uint32))
    mask = jnp.array([True, False, True, False])
    _, y1 = rng.masked_next_float(y0, mask)
    assert (np.array(y1)[1::2] == np.array(y0)[1::2]).all()
    assert (np.array(y1)[0::2] != np.array(y0)[0::2]).all()


def test_uniform_float_range():
    y = rng.seed(jnp.arange(1000, dtype=jnp.uint32))
    f, _ = rng.next_float(y)
    f = np.array(f)
    assert (f >= 0).all() and (f < 1.0).all()


def _scalar_latin_square(seed_val, n):
    """Scalar transcription of sampling.cpp:64-86 for oracle comparison."""
    sc = rng.ScalarRNG()
    sc.seed(seed_val)
    inv = np.float32(1.0 / n)
    samples = []
    for i in range(n):
        x = np.float32((np.float32(i) + np.float32(sc.uniform_float())) * inv)
        y = np.float32((np.float32(i) + np.float32(sc.uniform_float())) * inv)
        samples.append([x, y])
    samples = np.array(samples, np.float32)
    for i in range(n):
        c = sc.uniform_int32(n - 1 - i)
        samples[[i, c], 0] = samples[[c, i], 0]
        c = sc.uniform_int32(n - 1 - i)
        samples[[i, c], 1] = samples[[c, i], 1]
    return samples


def test_latin_square_matches_scalar():
    for n in [1, 2, 5, 16]:
        seeds = [0, 17, 999]
        state = rng.seed(jnp.array(seeds, dtype=jnp.uint32))
        got, _ = sampling.latin_square(state, n)
        got = np.array(got)
        for lane, s in enumerate(seeds):
            want = _scalar_latin_square(s, n)
            np.testing.assert_array_equal(want, got[lane])


def test_latin_square_is_latin():
    # every row and column stratum hit exactly once
    n = 16
    state = rng.seed(jnp.arange(8, dtype=jnp.uint32))
    s, _ = sampling.latin_square(state, n)
    s = np.array(s)
    for lane in range(8):
        for d in range(2):
            strata = np.floor(s[lane, :, d] * n).astype(int)
            assert sorted(strata.tolist()) == list(range(n))
