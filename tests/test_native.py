"""Native runtime core (libnartcore.so) vs pure-Python twins.

The native C++ path (nart_jax/native/core.cpp) must agree with the
behavior-defining Python implementations for .geo parsing, .vol parsing,
and the LBVH build.
"""

import glob
import os

import numpy as np
import pytest

from nart_jax import _native, accel, geo, vol

pytestmark = pytest.mark.skipif(
    _native.get() is None, reason="native core unavailable"
)

_MESH_DIR = "/root/reference/input/meshes"


def _loadable_meshes():
    out = []
    for p in sorted(glob.glob(os.path.join(_MESH_DIR, "**/*.geo"), recursive=True)):
        try:
            geo._load_geo_py(p, np.eye(4))
            out.append(p)
        except ValueError:
            continue
    return out[:6]


@pytest.mark.skipif(not os.path.isdir(_MESH_DIR), reason="no reference assets")
def test_geo_native_matches_python():
    rng = np.random.default_rng(3)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rng.normal(size=(3, 3)).astype(np.float32) + np.eye(3) * 2
    m[:3, 3] = [0.5, -1.0, 2.0]
    meshes = _loadable_meshes()
    assert meshes, "no parsable reference meshes found"
    for p in meshes:
        py = geo._load_geo_py(p, m)
        v, n, uv = _native.geo_load(p, m)
        np.testing.assert_allclose(v, py.v, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n, py.n, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(uv, py.uv)


@pytest.mark.skipif(not os.path.isdir(_MESH_DIR), reason="no reference assets")
def test_geo_native_rejects_bad_file_like_python():
    bad = os.path.join(_MESH_DIR, "teapot.geo")  # truncated UV section
    if not os.path.exists(bad):
        pytest.skip("teapot.geo absent")
    with pytest.raises(ValueError):
        geo._load_geo_py(bad, np.eye(4))
    with pytest.raises(ValueError):
        _native.geo_load(bad, np.eye(4))


def test_vol_native_matches_python(tmp_path):
    rng = np.random.default_rng(0)
    g = vol.VolGrid(
        bounds_min=np.array([-1, -2, 0], np.float32),
        bounds_max=np.array([1, 0.5, 3], np.float32),
        density=rng.random((5, 4, 3)).astype(np.float32),
    )
    p = str(tmp_path / "t.vol")
    vol.write_vol(p, g)
    py = vol._load_vol_py(p)
    bmin, bmax, density = _native.vol_load(p)
    np.testing.assert_array_equal(bmin, py.bounds_min)
    np.testing.assert_array_equal(bmax, py.bounds_max)
    np.testing.assert_array_equal(density, py.density)


def test_lbvh_native_matches_python():
    rng = np.random.default_rng(7)
    for t in (1, 7, 8, 9, 100, 1000):
        tri = (
            rng.normal(size=(t, 3, 3)).astype(np.float32) * 2.0
            + rng.normal(size=(t, 1, 3)).astype(np.float32) * 10.0
        )
        py = accel._build_bvh_py(tri, leaf_size=8)
        nat = accel.build_bvh(tri, leaf_size=8)
        assert nat.n_leaves == py.n_leaves
        np.testing.assert_array_equal(np.asarray(nat.order), np.asarray(py.order))
        np.testing.assert_array_equal(
            np.asarray(nat.tri_v), np.asarray(py.tri_v)
        )
        np.testing.assert_array_equal(
            np.asarray(nat.node_lo), np.asarray(py.node_lo)
        )
        np.testing.assert_array_equal(
            np.asarray(nat.node_hi), np.asarray(py.node_hi)
        )
