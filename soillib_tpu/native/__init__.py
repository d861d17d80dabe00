"""Native (C++) runtime — ctypes bindings with lazy on-demand build.

The reference's I/O and CPU-op layers are C++ (libtiff codec io/tiff.hpp,
PLY writer io/mesh.hpp, FastNoiseLite op/noise.hpp). This package holds
the equivalent native host-side hot paths: LZW/PackBits
decompression (the Python-loop-bound parts of io/tiffcore.py), heightfield
triangulation + PLY emission, and threaded FBm noise.

The shared library is compiled once with g++ on first use and cached next
to this file; every caller falls back to the pure-Python implementation if
the toolchain or binary is unavailable, so the framework stays importable
anywhere (`native.available()` reports which path is active).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "native.cpp")
_LIB = os.path.join(_DIR, "libsoilnative.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", _LIB, _SRC, "-lpthread",
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=240)
        return r.returncode == 0 and os.path.exists(_LIB)
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None

        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.soil_lzw_decode.restype = ctypes.c_longlong
        lib.soil_lzw_decode.argtypes = [u8p, ctypes.c_longlong, u8p,
                                        ctypes.c_longlong]
        lib.soil_packbits_decode.restype = ctypes.c_longlong
        lib.soil_packbits_decode.argtypes = [u8p, ctypes.c_longlong, u8p,
                                             ctypes.c_longlong]
        lib.soil_tri_count.restype = None
        lib.soil_tri_count.argtypes = [f32p, i64, i64, i64p, i64p]
        lib.soil_triangulate.restype = None
        lib.soil_triangulate.argtypes = [f32p, i64, i64, f32, f32, f32,
                                         f32p, i32p]
        lib.soil_ply_write.restype = ctypes.c_int
        lib.soil_ply_write.argtypes = [ctypes.c_char_p, f32p, i64, i32p, i64,
                                       ctypes.c_int]
        lib.soil_fbm2.restype = None
        lib.soil_fbm2.argtypes = [f32p, i64, i64, f32, f32, f32,
                                  ctypes.c_int, f32, f32, f32]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _u8(buf) -> "ctypes.POINTER":
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)


def lzw_decode(data: bytes, expected: int):
    """TIFF LZW decode; None if native unavailable or stream malformed."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected, np.uint8)
    n = lib.soil_lzw_decode(
        _u8(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected,
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def packbits_decode(data: bytes, expected: int):
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected, np.uint8)
    n = lib.soil_packbits_decode(
        _u8(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), expected,
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def triangulate(h: np.ndarray, scale):
    """(vertices, faces) like io/mesh.hpp:49-118; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, np.float32)
    W, H = h.shape
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    hp = h.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.soil_tri_count(hp, W, H, ctypes.byref(nv), ctypes.byref(nf))
    verts = np.empty((nv.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    lib.soil_triangulate(
        hp, W, H, float(scale[0]), float(scale[1]), float(scale[2]),
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return verts, faces


def ply_write(path: str, vertices: np.ndarray, faces: np.ndarray,
              binary: bool) -> bool:
    lib = _load()
    if lib is None:
        return False
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    rc = lib.soil_ply_write(
        path.encode(), v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(v), f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f),
        1 if binary else 0,
    )
    return rc == 0


def fbm2(shape, ext, frequency, octaves, gain, lacunarity, z):
    """Threaded CPU FBm, numerically matching ops/noise.py's jax kernel."""
    lib = _load()
    if lib is None:
        return None
    W, H = int(shape[0]), int(shape[1])
    out = np.empty((W, H), np.float32)
    lib.soil_fbm2(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), W, H,
        1.0 / float(ext[0]), 1.0 / float(ext[1]), float(frequency),
        int(octaves), float(gain), float(lacunarity), float(z),
    )
    return out
