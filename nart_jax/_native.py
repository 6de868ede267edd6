"""ctypes binding for the native runtime core (nart_jax/native/core.cpp).

The native side owns the cold-path runtime work the reference also does in
C++ — .geo parse + fan-triangulation + world transform (scene.cpp:77-343),
.vol parse (scene.cpp:825-867), LBVH build (role of bvh.cpp:252-326).  Every
entry point has a pure-Python behavioral twin (geo.py / vol.py / accel.py)
used when the shared library cannot be built; tests/test_native.py asserts
the two paths agree exactly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_lib = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def get() -> Optional[ctypes.CDLL]:
    """Build (once, on demand) and load libnartcore.so; None on failure."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = os.path.join(_NATIVE_DIR, "libnartcore.so")
    src = os.path.join(_NATIVE_DIR, "core.cpp")
    if not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
    ):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "libnartcore.so"],
                check=True,
                capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.geo_open.argtypes = [ctypes.c_char_p, _f32p, _f32p, _i64p]
        lib.geo_read_into.argtypes = [_f32p, _f32p, _f32p]
        lib.vol_open.argtypes = [ctypes.c_char_p, _f64p]
        lib.vol_read_into.argtypes = [_f32p]
        lib.lbvh_build.argtypes = [
            _f32p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            _f32p,
            _f32p,
            _i32p,
            _f32p,
        ]
        lib.core_last_error.restype = ctypes.c_char_p
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def geo_load(path: str, object_to_world: np.ndarray):
    """Native .geo load; returns (v, n, uv) arrays or None if unavailable.

    Raises ValueError on parse errors (same contract as geo.load_geo)."""
    lib = get()
    if lib is None:
        return None
    a = np.ascontiguousarray(object_to_world, np.float32).reshape(4, 4)
    nm = np.ascontiguousarray(
        np.linalg.inv(a.astype(np.float32))[:3, :3].T, np.float32
    )
    n_tris = ctypes.c_int64()
    rc = lib.geo_open(
        path.encode(), _ptr(a, _f32p), _ptr(nm, _f32p), ctypes.byref(n_tris)
    )
    if rc != 0:
        raise ValueError(
            f"mesh file {path}: {lib.core_last_error().decode()}"
        )
    t = n_tris.value
    v = np.empty((t, 3, 3), np.float32)
    n = np.empty((t, 3, 3), np.float32)
    uv = np.empty((t, 3, 2), np.float32)
    lib.geo_read_into(_ptr(v, _f32p), _ptr(n, _f32p), _ptr(uv, _f32p))
    return v, n, uv


def vol_load(path: str):
    """Native .vol load; returns (bmin, bmax, density[z,y,x]) or None."""
    lib = get()
    if lib is None:
        return None
    header = np.zeros(9, np.float64)
    rc = lib.vol_open(path.encode(), _ptr(header, _f64p))
    if rc != 0:
        raise ValueError(
            f"volume file {path}: {lib.core_last_error().decode()}"
        )
    rx, ry, rz = (int(x) for x in header[6:9])
    density = np.empty(rx * ry * rz, np.float32)
    lib.vol_read_into(_ptr(density, _f32p))
    return (
        header[0:3].astype(np.float32),
        header[3:6].astype(np.float32),
        density.reshape(rz, ry, rx),
    )


def lbvh_build(tri_v: np.ndarray, leaf_size: int, n_leaves: int):
    """Native LBVH build; returns (node_lo, node_hi, order, tri_out) or None."""
    lib = get()
    if lib is None:
        return None
    tri_v = np.ascontiguousarray(tri_v, np.float32)
    t = len(tri_v)
    t_pad = n_leaves * leaf_size
    n_nodes = 2 * n_leaves - 1
    node_lo = np.empty((n_nodes, 3), np.float32)
    node_hi = np.empty((n_nodes, 3), np.float32)
    order = np.empty(t_pad, np.int32)
    tri_out = np.empty((t_pad, 3, 3), np.float32)
    lib.lbvh_build(
        _ptr(tri_v, _f32p),
        t,
        leaf_size,
        n_leaves,
        _ptr(node_lo, _f32p),
        _ptr(node_hi, _f32p),
        _ptr(order, _i32p),
        _ptr(tri_out, _f32p),
    )
    return node_lo, node_hi, order, tri_out
