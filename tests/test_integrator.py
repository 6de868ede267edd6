"""Wavefront integrator vs scalar oracle + physical sanity checks."""

import os

import jax.numpy as jnp
import numpy as np

from nart_jax import render as render_mod
from tests import oracle, scenes


def _compare(scene, params, rtol=2e-3, atol=2e-3, state_frac=0.95,
             modes=None):
    """Check reference-stream wavefront modes against the oracle.

    The oracle transcribes the reference's per-pixel sequential RNG
    stream; "spp" and "regen" preserve that layout bit-exactly (the
    "balanced" default uses per-(pixel,sample) streams and is validated
    statistically in test_balanced_matches_regen).  Default suite runs
    "regen" only (each mode is a separate full wavefront compile and the
    suite is compile-bound; "spp" shares the identical bounce body and is
    pinned by test_lambert_matches_oracle's both-mode run); set
    NART_SLOW_TESTS=1 to run both modes everywhere."""
    import dataclasses

    if modes is None:
        modes = (
            ("spp", "regen") if os.environ.get("NART_SLOW_TESTS")
            else ("regen",)
        )
    want, states = oracle.render_oracle(scene, params)
    w = np.where(want[..., 4:5] > 0, want, 0)
    for mode in modes:
        p = dataclasses.replace(params, wavefront=mode)
        got = render_mod.RenderSession(scene, p).render()
        g = np.where(got[..., 4:5] > 0, got, 0)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def test_lambert_matches_oracle():
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=6, image_height=6, bucket_size=16, spp=2, bounces=3,
        filter_width=1.0, roughening_factor=0.0,
    )
    _compare(scene, params, modes=("spp", "regen"))


def test_plastic_rr_matches_oracle():
    # bounces > 4 exercises Russian roulette; plastic exercises 2-lobe mixing
    scene = scenes.simple_scene(("plastic",), roughness=0.5)
    params = render_mod.RenderParams(
        image_width=5, image_height=5, bucket_size=16, spp=2, bounces=6,
        filter_width=1.0, roughening_factor=0.3,
    )
    _compare(scene, params)


def test_glass_nested_matches_oracle():
    # two stacked glass quads with priorities exercises the isect list
    scene = scenes.simple_scene(
        ("glass", "glass", "lambert"), roughness=0.0, priorities=[2, 1, 0]
    )
    params = render_mod.RenderParams(
        image_width=4, image_height=4, bucket_size=16, spp=2, bounces=6,
        filter_width=1.0, roughening_factor=0.0,
    )
    _compare(scene, params, rtol=5e-3, atol=5e-3)


def test_alpha_and_background():
    # rays that miss everything: alpha 0, black
    scene = scenes.simple_scene(("lambert",))
    params = render_mod.RenderParams(
        image_width=16, image_height=16, spp=2, bounces=3, filter_width=1.0
    )
    sess = render_mod.RenderSession(scene, params)
    img = sess.image()
    assert not np.isnan(img).any()
    # corners see background (quad half-angle < fov at corners)
    assert img[0, 0, 3] < 0.5
    # center sees the lit quad
    assert img[8, 8, 3] > 0.5
    assert img[8, 8, :3].max() > 0.01


def test_accel_paths_agree():
    # the brute-force and BVH intersectors must produce the same image
    import dataclasses

    scene = scenes.simple_scene(("plastic", "lambert"), roughness=0.4)
    params = render_mod.RenderParams(
        image_width=6, image_height=6, spp=2, bounces=4, filter_width=1.0,
        accel="bvh",
    )
    film_bvh = render_mod.RenderSession(scene, params).render()
    params_b = dataclasses.replace(params, accel="brute")
    film_brute = render_mod.RenderSession(scene, params_b).render()
    np.testing.assert_allclose(film_bvh, film_brute, rtol=1e-5, atol=1e-6)


def test_balanced_matches_regen():
    """The balanced work-queue wavefront is an unbiased estimator of the
    same integral as the reference-stream modes: means agree within MC
    noise, and it is bit-deterministic + chunk-size invariant (per-item
    RNG streams depend only on global (pixel, sample) ids)."""
    import dataclasses

    scene = scenes.simple_scene(("plastic",), roughness=0.5, intensity=4.0)
    base = render_mod.RenderParams(
        image_width=8, image_height=8, spp=32, bounces=4, filter_width=1.0
    )
    img_regen = render_mod.RenderSession(
        scene, dataclasses.replace(base, wavefront="regen")
    ).image()
    p_bal = dataclasses.replace(base, wavefront="balanced")
    img_bal = render_mod.RenderSession(scene, p_bal).image()
    # unbiasedness: same mean within MC noise at 32 spp
    m_r, m_b = img_regen[..., :3].mean(), img_bal[..., :3].mean()
    assert abs(m_r - m_b) / max(m_r, 1e-6) < 0.1, (m_r, m_b)
    # determinism + chunk invariance: different chunking, identical image
    p_chunked = dataclasses.replace(p_bal, spp_chunk=8)
    img_chunked = render_mod.RenderSession(scene, p_chunked).image()
    np.testing.assert_array_equal(img_bal, img_chunked)
    # lane-count invariance: the work queue assigns the same streams
    p_lanes = dataclasses.replace(p_bal, lanes=100)
    img_lanes = render_mod.RenderSession(scene, p_lanes).image()
    np.testing.assert_array_equal(img_bal, img_lanes)


def test_mis_strategies_converge():
    # classic Veach check: BSDF-only and light-only sampling must converge
    # to the same mean image (the MIS toggles mirror the reference's
    # BSDF_SAMPLING / LIGHT_SAMPLING compile switches)
    import dataclasses

    scene = scenes.simple_scene(("plastic",), roughness=0.6, intensity=8.0)
    base = render_mod.RenderParams(
        image_width=6, image_height=6, spp=48, bounces=2, filter_width=1.0
    )
    means = {}
    for name, kw in (
        ("bsdf", dict(mis_light=False)),
        ("light", dict(mis_bsdf=False)),
        ("both", {}),
    ):
        p = dataclasses.replace(base, **kw)
        img = render_mod.RenderSession(scene, p).image()
        means[name] = img[..., :3].mean()
    # all three estimate the same integral
    assert abs(means["bsdf"] - means["light"]) / means["both"] < 0.12, means
    assert abs(means["both"] - means["light"]) / means["both"] < 0.12, means
