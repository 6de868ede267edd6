"""EXR image I/O.

Two paths:
  1. native: ctypes binding to nart_jax/native/libnartexr.so (OpenEXR C++),
     built on demand with `make -C nart_jax/native`.  Handles every
     compression (incl. PIZ, used by half the reference textures).
  2. pure-Python fallback codec for NONE/RLE/ZIPS/ZIP scanline images
     (numpy + zlib), and a ZIPS writer.

Parity: the reference reads textures via Imf::RgbaInputFile
(texturepattern.cpp:111-128) and writes RGBA half renders via
Imf::RgbaOutputFile (render.cpp:208-234).  `read()` returns float32 (h, w, 4)
RGBA; `write()` stores half RGBA.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_native_lib = None
_native_tried = False


def _get_native():
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    so = os.path.join(_NATIVE_DIR, "libnartexr.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "libnartexr.so"],
                check=True,
                capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.exr_read_open.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.exr_read_into.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.exr_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.exr_last_error.restype = ctypes.c_char_p
        _native_lib = lib
    except OSError:
        _native_lib = None
    return _native_lib


# ---------------------------------------------------------------------------
# Pure-Python scanline codec (fallback)
# ---------------------------------------------------------------------------

_MAGIC = 0x01312F76
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_SCANLINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16}  # none, rle, zips, zip


def _read_cstr(f):
    out = b""
    while True:
        c = f.read(1)
        if c in (b"\x00", b""):
            return out.decode("latin-1")
        out += c


def _parse_header(f):
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == "":
            return attrs
        typ = _read_cstr(f)
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name] = (typ, f.read(size))


def _parse_channels(data):
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b"\x00", i)
        name = data[i:j].decode("latin-1")
        ptype, xs, ys = struct.unpack("<i4xii", data[j + 1 : j + 17])
        chans.append((name, ptype, xs, ys))
        i = j + 17
    return chans


def _predictor_undo(d):
    # EXR zip/rle post-filter: delta-decode (x[i] = x[i-1] + d[i] - 128),
    # then merge the two byte planes (even positions | odd positions).
    d = np.frombuffer(d, np.uint8).astype(np.int64)
    n = len(d)
    d = (np.cumsum(d) - 128 * np.arange(n)) % 256
    d = d.astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half : half + n // 2]
    return out.tobytes()


def _predictor_apply(raw):
    d = np.frombuffer(raw, np.uint8)
    n = len(d)
    half = (n + 1) // 2
    inter = np.concatenate([d[0::2], d[1::2]])
    inter = inter.astype(np.int64)
    delta = np.empty(n, np.int64)
    delta[0] = inter[0]
    delta[1:] = inter[1:] - inter[:-1] + 128 + 256
    return (delta % 256).astype(np.uint8).tobytes(), half


def _rle_decode(data):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack("<b", data[i : i + 1])[0]
        if count < 0:
            out += data[i + 1 : i + 1 - count]
            i += 1 - count
        else:
            out += data[i + 1 : i + 2] * (count + 1)
            i += 2
    return bytes(out)


def _py_read(path):
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<I", f.read(4))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        version = f.read(4)
        if version[1] & 0x1A:
            raise NotImplementedError("tiled/deep/multipart EXR not supported")
        attrs = _parse_header(f)
        comp = attrs["compression"][1][0]
        if comp not in _SCANLINES_PER_BLOCK:
            raise NotImplementedError(
                f"compression {comp} needs the native OpenEXR module"
            )
        xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
        w, h = xmax - xmin + 1, ymax - ymin + 1
        chans = _parse_channels(attrs["channels"][1])
        spb = _SCANLINES_PER_BLOCK[comp]
        nblocks = (h + spb - 1) // spb
        f.read(8 * nblocks)  # offset table (we read sequentially)

        planes = {
            name: np.zeros((h, w), _PIXEL_TYPES[pt]) for name, pt, _, _ in chans
        }
        bytes_per_row = sum(np.dtype(_PIXEL_TYPES[pt]).itemsize * w for _, pt, _, _ in chans)
        for _ in range(nblocks):
            y0, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            rows = min(spb, ymax - y0 + 1)
            expect = bytes_per_row * rows
            if comp == 0 or len(data) == expect:
                raw = data  # stored raw (compression did not help)
            elif comp == 1:
                raw = _predictor_undo(_rle_decode(data))
            else:
                raw = _predictor_undo(zlib.decompress(data))
            if len(raw) != expect:
                raise ValueError(f"bad scanline block in {path}")
            off = 0
            for r in range(rows):
                for name, pt, _, _ in chans:  # channels stored alphabetically
                    dt = np.dtype(_PIXEL_TYPES[pt])
                    row = np.frombuffer(raw, dt, count=w, offset=off)
                    planes[name][y0 - ymin + r] = row
                    off += dt.itemsize * w

        out = np.zeros((h, w, 4), np.float32)
        out[..., 3] = 1.0
        for i, c in enumerate("RGBA"):
            if c in planes:
                out[..., i] = planes[c].astype(np.float32)
        return out


def _py_write(path, rgba):
    h, w, _ = rgba.shape
    half = rgba.astype(np.float16)
    chans = b""
    for name in (b"A", b"B", b"G", b"R"):
        chans += name + b"\x00" + struct.pack("<i4xii", 1, 1, 1)
    chans += b"\x00"

    def attr(name, typ, data):
        return (
            name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data
        )

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chans)
        + attr("compression", "compression", b"\x02")  # ZIPS
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    blocks = []
    for y in range(h):
        row = b"".join(
            half[y, :, c].tobytes() for c in (3, 2, 1, 0)  # A, B, G, R
        )
        filtered, _ = _predictor_apply(row)
        comp = zlib.compress(filtered)
        if len(comp) >= len(row):
            comp = row  # stored raw when compression does not help
        blocks.append(struct.pack("<ii", y, len(comp)) + comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _MAGIC) + b"\x02\x00\x00\x00")
        f.write(header)
        offset = 4 + 4 + len(header) + 8 * h
        for b in blocks:
            f.write(struct.pack("<Q", offset))
            offset += len(b)
        for b in blocks:
            f.write(b)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def read(path):
    """Read an EXR into float32 (h, w, 4) RGBA."""
    lib = _get_native()
    if lib is not None:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        if lib.exr_read_open(path.encode(), ctypes.byref(w), ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 4), np.float32)
            lib.exr_read_into(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out
    return _py_read(path)


def write(path, rgba):
    """Write float32 (h, w, 4) RGBA as a half EXR."""
    rgba = np.asarray(rgba, np.float32)
    if rgba.ndim == 3 and rgba.shape[2] == 3:
        rgba = np.concatenate(
            [rgba, np.ones_like(rgba[..., :1])], axis=-1
        )
    lib = _get_native()
    if lib is not None:
        h, w, _ = rgba.shape
        data = np.ascontiguousarray(rgba)
        if (
            lib.exr_write(
                path.encode(),
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                w,
                h,
            )
            == 0
        ):
            return
    _py_write(path, rgba)
