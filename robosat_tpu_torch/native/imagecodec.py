"""Native image codec bindings: build-on-demand ctypes over imagecodec.cpp.

Counterpart of robosat_tpu/native/imagecodec.py, limited to what `predict`
and `masks` use: RGB tile decode (PNG/JPEG/WebP), the index decode of
palette PNGs and the two palette-PNG encoders.
The library builds with g++ from this package's own copy of the source at
first use, into `robosat_tpu_torch/_build/` (rebuilt when the source is
newer). Any failure (build, a missing libjpeg or libwebp, an unsupported
sub-format, a corrupt file) falls back to PIL, which stays the correctness
oracle in the tests.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "imagecodec.cpp")
_LIB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "_imagecodec.so")

_lib = None
_tried = False


def _build():
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = "{}.tmp{}".format(_LIB, os.getpid())
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC, "-lz", "-ljpeg", "-lwebp"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def load():
    """The loaded native library, building it if needed; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rs_image_info.restype = ctypes.c_int
        lib.rs_image_info.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.rs_decode_rgb.restype = ctypes.c_int
        lib.rs_decode_rgb.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        lib.rs_decode_indices.restype = ctypes.c_int
        lib.rs_decode_indices.argtypes = lib.rs_decode_rgb.argtypes
        lib.rs_encode_palette_png.restype = ctypes.c_int
        lib.rs_encode_palette_png.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
        ]
        lib.rs_encode_palette_png_d2s.restype = ctypes.c_int
        lib.rs_encode_palette_png_d2s.argtypes = lib.rs_encode_palette_png.argtypes
        _lib = lib
    except Exception as exc:
        print("Warning: native image codec unavailable ({}); using PIL".format(exc), file=sys.stderr)
        _lib = None
    return _lib


def _decode(path, entry, channels):
    """Run a native decode entry into a fresh (H, W, *channels) uint8
    array, or None if the native path can't handle the file."""
    lib = load()
    if lib is None:
        return None
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    if lib.rs_image_info(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, *channels), np.uint8)
    rc = getattr(lib, entry)(path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w.value, h.value)
    return out if rc == 0 else None


def decode_rgb(path):
    """Decode an image file to an (H, W, 3) uint8 array, or None if the
    native fast path can't handle it (caller falls back to PIL)."""
    return _decode(path, "rs_decode_rgb", (3,))


def decode_indices(path):
    """Decode an 8-bit palette/gray PNG as its raw (H, W) uint8 index array
    (no palette applied), or None for the PIL fallback."""
    return _decode(path, "rs_decode_indices", ())


def _as_palette(palette):
    pal = np.ascontiguousarray(np.asarray(palette, np.uint8).reshape(-1))
    assert pal.size % 3 == 0 and pal.size <= 768
    return pal


def encode_palette_png(path, indices, palette, level=1):
    """Write an (H, W) uint8 index array as a palette PNG. Returns True on
    success; False means fall back to PIL."""
    lib = load()
    if lib is None:
        return False
    idx = np.ascontiguousarray(indices, np.uint8)
    assert idx.ndim == 2
    pal = _as_palette(palette)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.rs_encode_palette_png(
        path.encode(), idx.ctypes.data_as(u8), idx.shape[0], idx.shape[1],
        pal.ctypes.data_as(u8), pal.size // 3, level,
    )
    return rc == 0


def encode_palette_png_d2s(path, blocked, palette, level=1):
    """Write a parity-blocked (H/2, W/2, 4) uint8 tile (the predict fast
    path's space_to_depth2 layout) as the interleaved (H, W) palette PNG in
    one native pass."""
    lib = load()
    if lib is None:
        return False
    blk = np.ascontiguousarray(blocked, np.uint8)
    assert blk.ndim == 3 and blk.shape[2] == 4
    h, w = blk.shape[0] * 2, blk.shape[1] * 2
    pal = _as_palette(palette)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.rs_encode_palette_png_d2s(
        path.encode(), blk.ctypes.data_as(u8), h, w, pal.ctypes.data_as(u8), pal.size // 3, level
    )
    return rc == 0
