"""Scene loader tests against the reference's bundled scenes."""

import numpy as np
import pytest

from nart_jax import geo, scene as scene_mod

REF = "/root/reference"


def _have_ref():
    import os

    return os.path.isdir(REF)


pytestmark = pytest.mark.skipif(not _have_ref(), reason="reference not mounted")


def test_glass_sphere_scene():
    s = scene_mod.load_scene(f"{REF}/input/scenes/glassSphere.json", asset_root=REF)
    assert s.n_meshes == 3
    assert s.n_tris > 100
    assert [int(p) for p in s.mesh_priority] == [2, 3, 0]
    assert [int(m) for m in s.mat_type] == [
        scene_mod.MAT_GLASS, scene_mod.MAT_GLASS, scene_mod.MAT_LAMBERT,
    ]
    np.testing.assert_allclose(np.asarray(s.eta_const), [1.5, 1.0, 0.0])
    # lambert rho_d bare-array: unclamped parity value
    np.testing.assert_allclose(np.asarray(s.rho_d_const)[2], [0.03, 0.03, 0.03])
    assert len(s.lights) == 1
    li = s.lights[0]
    assert li.kind == scene_mod.LIGHT_DISK
    assert li.radius == 0.5 and li.intensity == np.float32(259.4)
    assert s.fov == 11.5


def test_veach_scene_sessions():
    from nart_jax import render as render_mod

    sessions = render_mod.load_sessions(f"{REF}/input/scenes/veach.json", {})
    assert len(sessions) == 1
    p = sessions[0]
    assert (p.image_width, p.image_height, p.spp) == (1280, 720, 512)
    assert p.bounces == 10  # default fill-in
    assert p.roughening_factor == 0.0
    # CLI override precedence
    s2 = render_mod.load_sessions(
        f"{REF}/input/scenes/veach.json", {"spp": 8, "roughening_factor": 2.0}
    )[0]
    assert s2.spp == 8
    assert s2.roughening_factor == 1.0  # clamped


def test_macbeth_textures():
    s = scene_mod.load_scene(f"{REF}/input/scenes/macbeth.json", asset_root=REF)
    # plane mesh has a texture rho_d; env light has texture + cdf
    assert (np.asarray(s.rho_d_tex) >= 0).any()
    env = [li for li in s.lights if li.kind == scene_mod.LIGHT_ENV]
    assert len(env) == 1
    assert env[0].env2d is not None
    assert env[0].le_tex is not None
    # marginal pdf normalised: mean == 1
    assert abs(float(np.asarray(env[0].env2d.marg_pdf).mean()) - 1.0) < 1e-3


def test_geo_plane():
    arr = geo.load_geo(f"{REF}/input/meshes/plane.geo", np.eye(4, dtype=np.float32))
    assert arr.v.shape[1:] == (3, 3)
    assert len(arr.v) >= 1
    # normals unit length
    np.testing.assert_allclose(
        np.linalg.norm(arr.n.reshape(-1, 3), axis=-1), 1.0, atol=1e-5
    )


def test_ring_scene_multi_session():
    from nart_jax import render as render_mod

    sessions = render_mod.load_sessions(f"{REF}/input/scenes/ring.json", {})
    assert len(sessions) == 3
    assert [s.roughening_factor for s in sessions] == [0.0, 0.2, 0.3]
