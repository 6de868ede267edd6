"""Volume integrator tests: analytic transmittance + conservative furnace."""

import jax.numpy as jnp
import numpy as np

from nart_jax import render as render_mod
from nart_jax.integrators import volume as vol_int
from nart_jax.scene import LIGHT_ENV, LightData, MediumData
from nart_jax import rng
from tests import scenes


def _medium(sigma_a, sigma_s, le=(0, 0, 0), density=None):
    dens = density if density is not None else np.ones((4, 4, 4), np.float32)
    return MediumData(
        bounds_min=np.float32([-1, -1, -1]),
        bounds_max=np.float32([1, 1, 1]),
        sigma_a=sigma_a,
        sigma_s=sigma_s,
        le=np.asarray(le, np.float32),
        density=dens,
        sigma_maj=float(dens.max()) * (sigma_a + sigma_s),
    )


def _env_scene(sigma_a, sigma_s, med_le=(0, 0, 0), env=1.0):
    scn = scenes.simple_scene(("lambert",))
    light = LightData(
        kind=LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=env,
        le_const=np.ones(3, np.float32), le_tex=None, env2d=None,
    )
    return scn.__class__(
        **{
            **{f: getattr(scn, f) for f in scn.__dataclass_fields__},
            "lights": [light],
            "medium": _medium(sigma_a, sigma_s, med_le),
        }
    )


def _trace(scn, n=4096, bounces=64, seed0=0):
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    state = rng.seed(jnp.arange(seed0, seed0 + n, dtype=jnp.uint32))
    params = render_mod.RenderParams(bounces=bounces, integrator="volume")
    l, a, _, _ = vol_int.trace(scn, None, o, d, state, params)
    return np.asarray(l), np.asarray(a)


def test_pure_absorption_transmittance():
    # homogeneous absorber: E[L] = exp(-sigma_a * path_len) * env
    l, a = _trace(_env_scene(sigma_a=0.5, sigma_s=0.0))
    want = np.exp(-0.5 * 2.0)
    got = l[:, 0].mean()
    assert abs(got - want) / want < 0.05, (got, want)
    assert (a == 1.0).all()


def test_emission_plus_transmittance():
    # absorber with emission Le: L = T*env + (1-T)*Le for uniform medium
    l, _ = _trace(_env_scene(sigma_a=0.8, sigma_s=0.0, med_le=(2.0, 2.0, 2.0)))
    t = np.exp(-0.8 * 2.0)
    want = t * 1.0 + (1 - t) * 2.0
    got = l[:, 0].mean()
    assert abs(got - want) / want < 0.05, (got, want)


def test_conservative_scattering_furnace():
    # pure scatterer inside a uniform unit environment: every path exits
    # eventually with throughput 1 -> L == env exactly
    l, _ = _trace(_env_scene(sigma_a=0.0, sigma_s=1.5), bounces=512)
    np.testing.assert_allclose(l[:, 0], 1.0, atol=1e-4)


def test_no_medium_passthrough():
    scn = _env_scene(0.5, 0.0)
    scn = scn.__class__(
        **{
            **{f: getattr(scn, f) for f in scn.__dataclass_fields__},
            "medium": None,
        }
    )
    l, a = _trace(scn)
    np.testing.assert_allclose(l[:, 0], 1.0, atol=1e-6)


def test_volume_gradients_sigma_le_density():
    """Differentiable delta tracking: event-probability ratios carry
    gradients to sigma_a / sigma_s / Le / density (VERDICT r2 #8).

    Medium Le does not influence any sampling decision, so its AD gradient
    must match FD exactly; sigma gradients are checked for finiteness and
    physical sign (pure emission: more absorption -> brighter; pure
    transmittance: more absorption -> darker)."""
    import dataclasses

    import jax

    params = render_mod.RenderParams(bounces=64, integrator="volume")
    n = 2048
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    state = rng.seed(jnp.arange(n, dtype=jnp.uint32))

    def loss(theta, scn):
        med = dataclasses.replace(scn.medium, **theta)
        s = dataclasses.replace(scn, medium=med)
        l, _, _, _, unfinished = vol_int.trace_diff(s, None, o, d, state, params)
        return jnp.sum(l) / n

    # pure emission (env=0): dL/d sigma_a > 0, dL/d le > 0
    scn = _env_scene(sigma_a=0.8, sigma_s=0.0, med_le=(2.0, 2.0, 2.0), env=0.0)
    theta = {"sigma_a": jnp.float32(0.8), "le": jnp.asarray(scn.medium.le),
             "density": jnp.asarray(scn.medium.density)}
    g = jax.grad(lambda t: loss(t, scn))(theta)
    assert float(g["sigma_a"]) > 0
    assert np.isfinite(np.asarray(g["density"])).all()
    assert np.abs(np.asarray(g["density"])).sum() > 0
    # Le gradient == FD exactly (no decision depends on Le)
    eps = 1e-2
    up = float(loss({**theta, "le": theta["le"] + eps}, scn))
    dn = float(loss({**theta, "le": theta["le"] - eps}, scn))
    g_fd = (up - dn) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(g["le"]).sum()), g_fd,
                               rtol=1e-3)

    # pure transmittance (le=0, env=1): dL/d sigma_a < 0.  The density must
    # sit strictly below the majorant (non-uniform grid): at density ==
    # majorant the null-event probability is 0 and the ratio estimator's
    # gradient support vanishes (the delta-tracking boundary degeneracy).
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    scn2 = dataclasses.replace(
        _env_scene(sigma_a=0.5, sigma_s=0.0, env=1.0),
        medium=_medium(0.5, 0.0, density=dens),
    )
    theta2 = {"sigma_a": jnp.float32(0.5)}
    g2 = jax.grad(lambda t: loss(t, scn2))(theta2)
    assert float(g2["sigma_a"]) < 0


def test_volume_balanced_matches_lockstep_mean():
    """The work-queue volume wavefront is an unbiased estimator of the same
    integral (per-item streams differ from per-pixel streams, so agreement
    is statistical), and is deterministic + lane-count invariant."""
    import dataclasses

    scn = _env_scene(sigma_a=0.4, sigma_s=0.8, med_le=(0.5, 0.5, 0.5), env=1.0)
    params = render_mod.RenderParams(
        image_width=8, image_height=8, spp=32, bounces=64,
        integrator="volume", filter_width=1.0,
    )
    img_lock = render_mod.RenderSession(
        scn, dataclasses.replace(params, wavefront="spp")
    ).image()
    img_bal = render_mod.RenderSession(
        scn, dataclasses.replace(params, wavefront="balanced")
    ).image()
    m_l, m_b = img_lock[..., :3].mean(), img_bal[..., :3].mean()
    assert abs(m_l - m_b) / max(m_l, 1e-6) < 0.1, (m_l, m_b)

    img_lanes = render_mod.RenderSession(
        scn, dataclasses.replace(params, wavefront="balanced", lanes=128)
    ).image()
    np.testing.assert_array_equal(img_bal, img_lanes)
