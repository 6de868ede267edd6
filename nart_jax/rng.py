"""Bit-exact Marsaglia Xorshift32 RNG streams, vectorised over ray wavefronts.

Parity target: reference include/nart/core/rng.h:8-59 (Xorshift32 13/17/5 with
a golden-ratio output scramble) and the per-pixel seeding scheme
src/core/render.cpp:81-82 (``Seed(y * totalWidth + x)``).

Design: the reference consumes a *sequential* per-pixel stream (Latin-square
image samples first, then every path draw for every spp in order).  Here we
keep one uint32 state lane per pixel in the wavefront and advance it with
*masked* draws, so every lane consumes draws at exactly the positions the
reference's scalar control flow would — this is what makes golden-image
comparisons against the scalar oracle meaningful (see tests/oracle.py).

All ops are uint32 (wrapping) and float32, identical on CPU and GPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_MARSAGLIA_SEED = np.uint32(2463534242)
_SCRAMBLE_F = np.uint32(0x9E3779BB)  # float path (rng.h UniformFloat)
_SCRAMBLE_I = np.uint32(0x9E3779B9)  # int path (rng.h UniformInt32)
_INV_2_32 = np.float32(2.3283064365386963e-10)  # == 2**-32, exact in f32
_ONE_MINUS_EPS = np.float32(1.0) - np.float32(1.1920928955078125e-07)


def seed(pixel_index):
    """RNG::Seed — state = seed + 2463534242 (uint32 wrap).  rng.h:10-13."""
    return (jnp.asarray(pixel_index).astype(jnp.uint32) + _MARSAGLIA_SEED).astype(
        jnp.uint32
    )


def _xorshift(y):
    """One Xorshift32 step (13/17/5).  rng.h:24-27."""
    y = y ^ (y << 13)
    y = y ^ (y >> 17)
    y = y ^ (y << 5)
    return y


def next_float(y):
    """RNG::UniformFloat — returns (value, new_state).  rng.h:15-41.

    value = min(1 - eps, float32(state * 0x9E3779BB) * 2^-32).
    """
    y = _xorshift(y)
    scrambled = (y * _SCRAMBLE_F).astype(jnp.uint32)
    f = jnp.minimum(_ONE_MINUS_EPS, scrambled.astype(jnp.float32) * _INV_2_32)
    return f, y


def _umulhi_small(a, b):
    """High 32 bits of uint32 a * uint32 b, valid for b < 2**16.

    (jnp lacks uint64 without x64 mode; the reference only calls
    UniformInt32 with max = nSamples - 1 - i, far below 2**16.)
    """
    a_lo = a & jnp.uint32(0xFFFF)
    a_hi = a >> 16
    mid = a_hi * b + ((a_lo * b) >> 16)
    return mid >> 16


def next_int32(y, max_inclusive):
    """RNG::UniformInt32(max) — returns (value in [0, max], new_state).

    rng.h:43-56: multiply-high remap of the scrambled state onto [0, max+1).
    """
    y = _xorshift(y)
    scrambled = (y * _SCRAMBLE_I).astype(jnp.uint32)
    max_inclusive = jnp.asarray(max_inclusive).astype(jnp.uint32)
    return _umulhi_small(scrambled, max_inclusive + jnp.uint32(1)), y


def masked_next_float(y, mask):
    """Draw a float only on lanes where ``mask``; other lanes keep state.

    The returned value on masked-off lanes is arbitrary (callers select it
    away); the state only advances on active lanes, preserving stream
    positions exactly as the reference's scalar control flow would.
    """
    f, y_new = next_float(y)
    return f, jnp.where(mask, y_new, y)


def masked_next_int32(y, max_inclusive, mask):
    v, y_new = next_int32(y, max_inclusive)
    return v, jnp.where(mask, y_new, y)


class ScalarRNG:
    """Plain-Python transcription of the reference RNG for oracle tests.

    Matches rng.h exactly using Python ints masked to 32 bits.
    """

    def __init__(self):
        self.y = 2463534242

    def seed(self, s):
        self.y = (int(s) + 2463534242) & 0xFFFFFFFF

    def _step(self):
        y = self.y
        y ^= (y << 13) & 0xFFFFFFFF
        y ^= y >> 17
        y ^= (y << 5) & 0xFFFFFFFF
        self.y = y & 0xFFFFFFFF

    def uniform_float(self):
        self._step()
        scrambled = (self.y * 0x9E3779BB) & 0xFFFFFFFF
        f = np.float32(np.float32(scrambled) * _INV_2_32)
        return float(min(_ONE_MINUS_EPS, f))

    def uniform_int32(self, max_inclusive):
        self._step()
        scrambled = (self.y * 0x9E3779B9) & 0xFFFFFFFF
        return (scrambled * (int(max_inclusive) + 1)) >> 32
