"""BSDF lobe tests: analytic values, sample<->pdf consistency, energy."""

import jax.numpy as jnp
import numpy as np

from nart_jax import bxdf


def _desc(n, rho_d=(1, 1, 1), rho_s=(1, 1, 1), tau=(1, 1, 1), eta=1.5,
          alpha=0.1, alpha_prime=None, lobe0=bxdf.L_LAMBERT, lobe1=-1,
          n_lobes=1):
    ap = alpha if alpha_prime is None else alpha_prime
    f3 = lambda v: jnp.tile(jnp.asarray(v, jnp.float32), (n, 1))
    f1 = lambda v: jnp.full((n,), np.float32(v))
    return bxdf.BsdfDesc(
        n_lobes=jnp.full((n,), n_lobes, jnp.int32),
        lobe=jnp.tile(jnp.asarray([lobe0, lobe1], jnp.int32), (n, 1)),
        rho_d=f3(rho_d),
        rho_s=f3(rho_s),
        tau=f3(tau),
        eta=f1(eta),
        alpha0=f1(max(1e-4, alpha)),
        alpha_prime=f1(ap),
    )


def _u2(n, seed=0):
    g = np.random.default_rng(seed)
    return jnp.asarray(g.random((n, 2), dtype=np.float32))


def _wo(n, seed=1):
    g = np.random.default_rng(seed)
    w = g.normal(size=(n, 3)).astype(np.float32)
    w[:, 2] = np.abs(w[:, 2]) + 0.05
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    return jnp.asarray(w)


def test_fresnel_values():
    # normal incidence, eta 1->1.5: ((1.5-1)/(2.5))^2 = 0.04
    fr = bxdf.fresnel(jnp.float32(1.0), jnp.float32(1.5), jnp.float32(1.0))
    np.testing.assert_allclose(float(fr), 0.04, rtol=1e-5)
    # TIR from dense to rare beyond critical angle
    crit = np.sqrt(1 - (1 / 1.5) ** 2)  # cos of critical angle
    fr = bxdf.fresnel(jnp.float32(1.5), jnp.float32(1.0), jnp.float32(crit * 0.9))
    assert float(fr) == 1.0
    # index matched
    assert float(bxdf.fresnel(jnp.float32(1.5), jnp.float32(1.5), jnp.float32(0.7))) == 0.0


def test_lambert_furnace():
    # integral of f*cos over hemisphere == rho_d (perfect importance sampling:
    # f*cos/pdf == rho_d exactly per sample)
    n = 4096
    d = _desc(n, rho_d=(0.7, 0.5, 0.3))
    f, wi, pdf, flags, alpha_i = bxdf.lambert_sample(d, _u2(n))
    ratio = np.asarray(f) * np.asarray(wi)[:, 2:3] / np.asarray(pdf)[:, None]
    np.testing.assert_allclose(ratio, np.tile([0.7, 0.5, 0.3], (n, 1)), atol=1e-5)
    assert (np.asarray(flags) == bxdf.DIFFUSE).all()


def test_ts_sample_pdf_consistency():
    # pdf returned by sample == pdf evaluated at (wo, wi)
    n = 2048
    d = _desc(n, alpha=0.2, lobe0=bxdf.L_TS)
    wo = _wo(n)
    use_prime = jnp.zeros((n,), bool)
    f, wi, pdf, flags, _ = bxdf.ts_sample(d, wo, _u2(n, 2), use_prime, jnp.ones(n))
    pdf2 = bxdf.ts_pdf(d, wo, wi, use_prime, jnp.ones(n))
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(pdf2), rtol=1e-4)
    assert (np.asarray(flags) == bxdf.GLOSSY).all()


def test_ts_white_furnace_weighted():
    # VNDF sampling: sum f*|cos|/pdf ~ albedo <= 1 (energy conservation,
    # equality only without masking loss); check bounded and substantial
    n = 8192
    d = _desc(n, rho_s=(1, 1, 1), alpha=0.3, eta=1e9, lobe0=bxdf.L_TS)
    wo = jnp.tile(jnp.asarray([[0.3, 0.0, 0.954]]), (n, 1))
    wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
    f, wi, pdf, _, _ = bxdf.ts_sample(d, wo, _u2(n, 3), jnp.zeros(n, bool), jnp.ones(n))
    w = np.asarray(f)[:, 0] * np.abs(np.asarray(wi)[:, 2]) / np.maximum(np.asarray(pdf), 1e-12)
    w = np.where(np.asarray(pdf) > 0, w, 0.0)
    mean = w.mean()
    assert 0.5 < mean <= 1.02, mean


def test_ggx_d_normalisation():
    # integral of D(wh) cos(wh) over hemisphere == 1
    n = 200_000
    g = np.random.default_rng(7)
    u = g.random((n, 2)).astype(np.float32)
    theta = np.arccos(np.sqrt(1 - u[:, 0]))  # cosine-weighted
    z = np.cos(theta)
    wh = np.stack(
        [np.sin(theta) * np.cos(2 * np.pi * u[:, 1]),
         np.sin(theta) * np.sin(2 * np.pi * u[:, 1]), z], -1
    ).astype(np.float32)
    alpha = jnp.full((n,), 0.4)
    d_vals = np.asarray(bxdf._d_ggx(jnp.asarray(wh), alpha))
    # pdf of wh = cos/pi  =>  E[D * cos / (cos/pi)] = pi * E[D]
    est = np.pi * d_vals.mean()
    assert abs(est - 1.0) < 0.05, est


def test_dielectric_sample_pdf_consistency():
    n = 4096
    d = _desc(n, alpha=0.15, eta=1.5, lobe0=bxdf.L_DIELECTRIC)
    wo = _wo(n, 5)
    g = np.random.default_rng(6)
    u1 = jnp.asarray(g.random(n, dtype=np.float32))
    use_prime = jnp.zeros((n,), bool)
    eta_outer = jnp.ones(n)
    prev = jnp.zeros((n,), jnp.int32)
    f, wi, pdf, flags, _ = bxdf.dielectric_sample(d, wo, u1, _u2(n, 7), use_prime, eta_outer, prev)
    # reference scales sampled pdf by the Fresnel lobe-choice probability;
    # consistency: sampled pdf == Pdf(wo,wi) * P(choice)
    pdf_eval = np.asarray(bxdf.dielectric_pdf(d, wo, wi, use_prime, eta_outer))
    ratio = np.asarray(pdf) / np.maximum(pdf_eval, 1e-12)
    ok = (ratio > -1e-6) & (ratio < 1.0 + 1e-4)
    assert ok.mean() > 0.999
    # transmissive flag tracks the sampled lobe; it agrees with an actual
    # side-crossing for all but grazing microfacets (tilted wh can refract
    # without crossing the macro surface — reference behavior)
    crossed = np.asarray(wo)[:, 2] * np.asarray(wi)[:, 2] < 0
    has_t = (np.asarray(flags) & bxdf.TRANSMISSIVE) != 0
    assert (crossed == has_t).mean() > 0.95


def test_specular_mirror():
    n = 16
    d = _desc(n, rho_s=(1, 1, 1), eta=1e9, lobe0=bxdf.L_SPECULAR)
    wo = _wo(n, 8)
    f, wi, pdf, flags, _ = bxdf.specular_sample(d, wo, jnp.ones(n))
    np.testing.assert_allclose(np.asarray(wi)[:, 2], np.asarray(wo)[:, 2], atol=1e-6)
    np.testing.assert_allclose(np.asarray(wi)[:, :2], -np.asarray(wo)[:, :2], atol=1e-6)
    assert (np.asarray(pdf) == 1.0).all()
    # eta -> inf: Fresnel -> 1, f = 1/|wi.z|
    np.testing.assert_allclose(
        np.asarray(f)[:, 0], 1.0 / np.abs(np.asarray(wi)[:, 2]), rtol=1e-4
    )


def test_specdiel_energy_split():
    # delta glass: f*|cos|/pdf summed over both lobes == 1 per sample set
    n = 4096
    d = _desc(n, rho_s=(1, 1, 1), tau=(1, 1, 1), eta=1.5, lobe0=bxdf.L_SPECDIEL)
    wo = _wo(n, 9)
    prev = jnp.zeros((n,), jnp.int32)
    f, wi, pdf, flags, _ = bxdf.specdiel_sample(d, wo, _u2(n, 10), jnp.ones(n), prev)
    w = np.asarray(f)[:, 0] * np.abs(np.asarray(wi)[:, 2]) / np.asarray(pdf)
    # reflection: Fr/|z| * |z| / Fr = 1; refraction: (eta^2 ratio)(1-Fr)/|z| |z| /(1-Fr) = ratio^2
    is_refl = ((np.asarray(flags) & bxdf.TRANSMISSIVE) == 0)
    np.testing.assert_allclose(w[is_refl], 1.0, rtol=1e-4)
    assert (w[~is_refl] <= 1.0 + 1e-4).all()  # (eta_o/eta_i)^2 <= 1 entering


def test_bsdf_two_lobe_mixing():
    # plastic: lambert + TS; sampled non-specular -> pdf averaged over lobes
    n = 4096
    d = _desc(
        n, rho_d=(0.5, 0.5, 0.5), rho_s=(1, 1, 1), eta=1.5, alpha=0.3,
        lobe0=bxdf.L_LAMBERT, lobe1=bxdf.L_TS, n_lobes=2,
    )
    wo = _wo(n, 11)
    g = np.random.default_rng(12)
    u1 = jnp.asarray(g.random(n, dtype=np.float32))
    prev = jnp.zeros((n,), jnp.int32)
    f, wi, pdf, flags, alpha_i, eta_s = bxdf.bsdf_sample_f(
        d, wo, u1, _u2(n, 13), jnp.ones((n,), bool), jnp.ones(n), prev
    )
    # manual: average of lobe pdfs at (wo, wi)
    up = jnp.ones((n,), bool)
    p_l = np.asarray(bxdf.lambert_pdf(wi))
    p_t = np.asarray(bxdf.ts_pdf(d, wo, wi, up, jnp.ones(n)))
    manual = (np.maximum(p_l, 0) * (p_l > 0) + np.maximum(p_t, 0) * (p_t > 0))
    got = np.asarray(pdf)
    # when both lobes have positive pdf the mixed pdf is their mean
    both = (p_l > 0) & (p_t > 0)
    np.testing.assert_allclose(got[both], (p_l + p_t)[both] / 2, rtol=2e-3)


def test_bsdf_sample_eta():
    n = 8
    d = _desc(n, eta=1.5, lobe0=bxdf.L_DIELECTRIC)
    eta = bxdf.bsdf_sample_eta(d, jnp.full((n,), 0.3))
    np.testing.assert_allclose(np.asarray(eta), 1.5)
    d = _desc(n, lobe0=bxdf.L_LAMBERT)
    eta = bxdf.bsdf_sample_eta(d, jnp.full((n,), 0.3))
    np.testing.assert_allclose(np.asarray(eta), 0.0)  # Lambert Get_eta == 0


def test_frame_roundtrip():
    n = 64
    g = np.random.default_rng(14)
    sn = g.normal(size=(n, 3)).astype(np.float32)
    sn /= np.linalg.norm(sn, axis=-1, keepdims=True)
    dpds = g.normal(size=(n, 3)).astype(np.float32)
    frame = bxdf.build_frame(jnp.asarray(sn), jnp.asarray(dpds))
    v = g.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    local = bxdf.to_local(frame, jnp.asarray(v))
    back = bxdf.to_world(frame, local)
    np.testing.assert_allclose(np.asarray(back), v, atol=1e-4)
    # orthonormality of (t, b) and n alignment
    t, b, nn = np.asarray(frame.t), np.asarray(frame.b), np.asarray(frame.n)
    np.testing.assert_allclose((t * b).sum(-1), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-5)
