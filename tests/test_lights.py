"""Light tests: disk/ring/env sample<->eval consistency, env CDF sampling."""

import jax.numpy as jnp
import numpy as np

from nart_jax import lights, scene as scene_mod


def _disk(radius=1.0, inner=0.0, kind=scene_mod.LIGHT_DISK, intensity=2.0):
    # facing -z at z=2 (light normal (0,0,-1) transforms to itself)
    xf = np.eye(4, dtype=np.float32)
    xf[2, 3] = 2.0
    return scene_mod.LightData(
        kind=kind, xf=xf, radius=radius, inner_radius=inner,
        intensity=intensity, le_const=np.array([1, 1, 1], np.float32),
        le_tex=None, env2d=None,
    )


def _u2(n, seed=0):
    g = np.random.default_rng(seed)
    return jnp.asarray(g.random((n, 2), dtype=np.float32))


def test_disk_sample_eval_agree():
    li = _disk()
    p = jnp.zeros((512, 3))
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(512))
    ev = lights.light_eval(li, p, wi)
    ok = np.asarray(pdf) > 0
    assert ok.all()
    np.testing.assert_allclose(np.asarray(ev.pdf)[ok], np.asarray(pdf)[ok], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(ev.t)[ok], np.asarray(dist)[ok], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(le)[ok], 2.0, rtol=1e-5)


def test_disk_pdf_solid_angle_integral():
    # E[1/pdf] over samples == solid angle subtended (MC identity)
    li = _disk(radius=0.5)
    n = 20000
    p = jnp.zeros((n, 3))
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(n, 3))
    inv = 1.0 / np.asarray(pdf)
    # solid angle of disk radius .5 at distance 2 on axis ~ pi r^2 cos/d^2
    approx = np.pi * 0.25 / 4.0
    assert abs(inv.mean() - approx) / approx < 0.05


def test_disk_backface_gives_zero():
    li = _disk()
    p = jnp.asarray([[0.0, 0.0, 5.0]])  # behind the light (normal -z)
    wi = jnp.asarray([[0.0, 0.0, -1.0]])
    ev = lights.light_eval(li, p, wi)
    assert float(ev.pdf[0]) == 0.0
    le, wi_s, pdf, dist, st = lights.light_sample(li, p, _u2(1))
    assert float(pdf[0]) == 0.0


def test_ring_inner_hole():
    li = _disk(radius=1.0, inner=0.5, kind=scene_mod.LIGHT_RING)
    # ray straight through the middle: inside the hole -> miss
    p = jnp.zeros((1, 3))
    ev = lights.light_eval(li, p, jnp.asarray([[0.0, 0.0, 1.0]]))
    assert float(ev.pdf[0]) == 0.0
    # sampled points always inside the annulus (reference maps r^2 from k=inner/R)
    n = 2048
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(n, 5))
    hit = np.asarray(wi) * np.asarray(dist)[:, None]  # point on plane z=2
    r = np.linalg.norm(hit[:, :2], axis=-1)
    assert (r <= 1.0 + 1e-5).all() and (r >= np.sqrt(0.5) - 1e-5).all()


def test_env_constant():
    li = scene_mod.LightData(
        kind=scene_mod.LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=3.0,
        le_const=np.array([1.0, 0.5, 0.25], np.float32), le_tex=None, env2d=None,
    )
    p = jnp.zeros((256, 3))
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(256, 6))
    np.testing.assert_allclose(np.asarray(le), np.tile([3.0, 1.5, 0.75], (256, 1)), rtol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(wi), axis=-1), 1.0, atol=1e-5
    )
    assert (np.asarray(dist) == lights.ENV_TMAX).all()
    ev = lights.light_eval(li, p, wi)
    np.testing.assert_allclose(np.asarray(ev.pdf), np.asarray(pdf), rtol=1e-3)


def test_env_texture_importance():
    # bright top half, black bottom half: all samples land in the top rows
    img = np.zeros((8, 16, 3), np.float32)
    img[:4] = 4.0  # image rows 0-3 are the TOP (v near 1 after flip)
    dist2d = scene_mod._build_env2d(img)
    li = scene_mod.LightData(
        kind=scene_mod.LIGHT_ENV, xf=np.eye(4, dtype=np.float32), radius=0.0,
        inner_radius=0.0, intensity=1.0, le_const=np.zeros(3, np.float32),
        le_tex=img, env2d=dist2d,
    )
    n = 4096
    p = jnp.zeros((n, 3))
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(n, 7))
    # sampled Le must always be the bright value
    np.testing.assert_allclose(np.asarray(le), 4.0, rtol=1e-4)
    assert (np.asarray(pdf) > 0).all()
    # eval pdf at sampled dirs matches sampled pdf (up to bin-edge roundtrip
    # wobble of the uv -> direction -> uv mapping near row boundaries)
    ev = lights.light_eval(li, p, wi)
    close = np.isclose(np.asarray(ev.pdf), np.asarray(pdf), rtol=2e-2)
    assert close.mean() > 0.9


def test_env2d_pdf_integrates_to_one():
    g = np.random.default_rng(8)
    img = g.random((16, 32, 3)).astype(np.float32)
    dist2d = scene_mod._build_env2d(img)
    # grid integral of pdf over uv square
    u, v = np.meshgrid(
        (np.arange(32) + 0.5) / 32, (np.arange(16) + 0.5) / 16
    )
    st = jnp.asarray(np.stack([u.ravel(), v.ravel()], -1).astype(np.float32))
    pdf = np.asarray(lights.env2d_pdf(dist2d, st))
    assert abs(pdf.mean() - 1.0) < 1e-3


def test_distant_light():
    # extension: reference defines DistantLight (distantlight.cpp) but its
    # loader can't construct it; ours can (kind=LIGHT_DISTANT)
    xf = np.eye(4, dtype=np.float32)  # direction = (0,0,-1): wi = (0,0,1)
    li = scene_mod.LightData(
        kind=scene_mod.LIGHT_DISTANT, xf=xf, radius=0.0, inner_radius=0.0,
        intensity=3.0, le_const=np.array([1.0, 0.5, 0.25], np.float32),
        le_tex=None, env2d=None,
    )
    p = jnp.zeros((16, 3))
    le, wi, pdf, dist, st = lights.light_sample(li, p, _u2(16))
    np.testing.assert_allclose(np.asarray(wi), [[0, 0, 1]] * 16, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pdf), 1.0)
    np.testing.assert_allclose(np.asarray(le), [[3.0, 1.5, 0.75]] * 16)
    assert np.isinf(np.asarray(dist)).all()
    # Li along any ray is zero with pdf 0 (delta light, distantlight.cpp:11-15)
    ev = lights.light_eval(li, p, wi)
    assert (np.asarray(ev.pdf) == 0).all() and (np.asarray(ev.le) == 0).all()


def test_distant_light_loads_from_json():
    import json as _json
    import tempfile, os
    doc = {
        "camera": {"fov": 45.0,
                   "transform": [float(x) for x in np.eye(4).flatten()]},
        "meshes": [],
        "lights": [
            {"type": "distant", "Le": [1.0, 1.0, 1.0], "intensity": 2.0,
             "transform": [float(x) for x in np.eye(4).flatten()]}
        ],
        "renderSessions": [],
    }
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "s.json")
        with open(path, "w") as f:
            _json.dump(doc, f)
        scn = scene_mod.load_scene(path)
    assert len(scn.lights) == 1
    assert scn.lights[0].kind == scene_mod.LIGHT_DISTANT


def test_area_pack_matches_per_light_eval():
    """Packed disk/ring tables (constant AND textured Le) agree with the
    per-light eval/sample path on every field."""
    g = np.random.default_rng(7)
    tex = g.random((8, 8, 3)).astype(np.float32) * 3.0
    import dataclasses

    lis = [
        _disk(radius=1.0),
        _disk(radius=0.7, inner=0.3, kind=scene_mod.LIGHT_RING,
              intensity=1.5),
        dataclasses.replace(_disk(radius=1.2, intensity=0.5), le_tex=tex),
    ]
    pack, rest = lights.pack_area_lights(lis)
    assert pack is not None and rest == ()
    n = 256
    p = jnp.asarray(g.standard_normal((n, 3)).astype(np.float32))
    wi = g.standard_normal((n, 3)).astype(np.float32)
    wi = jnp.asarray(wi / np.linalg.norm(wi, axis=-1, keepdims=True))
    u2 = _u2(n, 3)
    for row, li in enumerate(lis):
        sel = jnp.full((n,), row, jnp.int32)
        ev_p = lights.area_pack_eval(pack, sel, p, wi)
        ev_r = lights.light_eval(li, p, wi)
        np.testing.assert_allclose(ev_p.pdf, ev_r.pdf, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ev_p.le, ev_r.le, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            np.where(np.isfinite(ev_p.t), ev_p.t, 0),
            np.where(np.isfinite(ev_r.t), ev_r.t, 0), rtol=1e-5, atol=1e-6)
        s_le, s_wi, s_pdf, s_t = lights.area_pack_sample(pack, sel, p, u2)
        r_le, r_wi, r_pdf, r_t, _ = lights.light_sample(li, p, u2)
        np.testing.assert_allclose(s_pdf, r_pdf, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s_le, r_le, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s_wi, r_wi, rtol=1e-5, atol=1e-6)


def test_area_pack_nearest_matches_loop():
    """area_pack_nearest (one (N, L) batch) == the per-light nearest loop."""
    g = np.random.default_rng(11)
    lis = []
    for i in range(16):
        xf = np.eye(4, dtype=np.float32)
        xf[:3, 3] = g.standard_normal(3).astype(np.float32) * 2.0
        lis.append(scene_mod.LightData(
            kind=scene_mod.LIGHT_DISK, xf=xf,
            radius=float(0.5 + g.random()), inner_radius=0.0,
            intensity=np.float32(1.0 + i * 0.25),
            le_const=g.random(3).astype(np.float32), le_tex=None,
            env2d=None,
        ))
    pack, rest = lights.pack_area_lights(lis)
    n = 512
    o = jnp.asarray(g.standard_normal((n, 3)).astype(np.float32) * 3.0)
    d = g.standard_normal((n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    t_lim = jnp.full((n,), np.float32(np.inf))

    le_p, t_p, hit_p = lights.area_pack_nearest(pack, o, d, t_lim)

    le = np.zeros((n, 3), np.float32)
    t_best = np.full((n,), np.inf, np.float32)
    hit = np.zeros((n,), bool)
    for li in lis:
        ev = lights.light_eval(li, o, d)
        closer = np.asarray(ev.t) < t_best
        le = np.where(closer[:, None], np.asarray(ev.le), le)
        t_best = np.where(closer, np.asarray(ev.t), t_best)
        hit |= closer
    np.testing.assert_array_equal(np.asarray(hit_p), hit)
    np.testing.assert_allclose(
        np.where(hit, np.asarray(t_p), 0), np.where(hit, t_best, 0),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(le_p), le, rtol=1e-5, atol=1e-6)


def test_env2d_bracket_tables_match_plain_search():
    """h > 64 maps sample through the inverse-CDF bracket tables; stripping
    the tables (the plain searchsorted / row-gather path) must give
    identical samples and pdfs."""
    import dataclasses

    g = np.random.default_rng(5)
    img = g.gamma(0.5, 1.0, (96, 200, 3)).astype(np.float32)
    img[10:14] = 0.0  # black rows: zero-pdf bins the search must skip
    dist2d = scene_mod._build_env2d(img)
    assert dist2d.marg_inv is not None and dist2d.cond_inv is not None
    plain = dataclasses.replace(dist2d, marg_inv=None, cond_inv=None,
                                marg_steps=0, cond_steps=0)
    u2 = _u2(20000, seed=9)
    uv_t, pdf_t = lights.env2d_sample(dist2d, u2)
    uv_p, pdf_p = lights.env2d_sample(plain, u2)
    np.testing.assert_array_equal(np.asarray(uv_t), np.asarray(uv_p))
    np.testing.assert_array_equal(np.asarray(pdf_t), np.asarray(pdf_p))
