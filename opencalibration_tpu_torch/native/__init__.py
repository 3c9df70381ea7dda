"""Native (C++) host components with lazy g++ build + ctypes bindings
(copy of opencalibration_tpu/native/__init__.py).

Each library is compiled on first use with the system toolchain into
``build/native/`` beside the package, named by a hash of its sources, so
an edited source is rebuilt and the package directory holds no build
output. The EXIF parser falls back to the pure-Python reader when no
compiler is available; the JPEG codec has no fallback, and a failed build
raises with the compiler's messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_lock = threading.Lock()
_libs = {}

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")


def _build(name: str, sources) -> str:
    srcs = [os.path.join(_DIR, s) for s in sources]
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *srcs, "-o", tmp]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"building {out} failed: {' '.join(cmd)}\n{done.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources, required: bool = False):
    """Build (if needed) and dlopen a native library. On failure: None, or
    with ``required`` the error (the compiler's messages for a failed build)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(_build(name, sources))
        except Exception:
            if required:
                raise
            lib = None
        _libs[name] = lib
        return lib


def jpeg_library():
    """The JPEG codec (``jpeg.cpp``); raises if it cannot be built."""
    lib = load_library("ocjpeg", ["jpeg.cpp"], required=True)
    if not hasattr(lib, "_configured"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.oc_jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.oc_jpeg_header.restype = ctypes.c_int
        lib.oc_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
        lib.oc_jpeg_decode.restype = ctypes.c_int
        lib.oc_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
        lib.oc_jpeg_encode.restype = ctypes.c_int
        lib.oc_jpeg_free.argtypes = [u8p]
        lib.oc_jpeg_free.restype = None
        lib._configured = True
    return lib


class ExifResult(ctypes.Structure):
    _fields_ = [
        ("has_exif", ctypes.c_int32),
        ("has_gps", ctypes.c_int32),
        ("has_altitude", ctypes.c_int32),
        ("has_relative_altitude", ctypes.c_int32),
        ("has_orientation", ctypes.c_int32),
        ("make", ctypes.c_char * 64),
        ("model", ctypes.c_char * 64),
        ("lens_model", ctypes.c_char * 64),
        ("datetime", ctypes.c_char * 32),
        ("width_px", ctypes.c_int32),
        ("height_px", ctypes.c_int32),
        ("focal_length_mm", ctypes.c_double),
        ("focal_length_35mm", ctypes.c_double),
        ("focal_plane_x_res", ctypes.c_double),
        ("focal_plane_unit", ctypes.c_int32),
        ("latitude", ctypes.c_double),
        ("longitude", ctypes.c_double),
        ("altitude", ctypes.c_double),
        ("dop", ctypes.c_double),
        ("relative_altitude", ctypes.c_double),
        ("gimbal_roll_deg", ctypes.c_double),
        ("gimbal_pitch_deg", ctypes.c_double),
        ("gimbal_yaw_deg", ctypes.c_double),
        ("rtk_std_lon", ctypes.c_double),
        ("rtk_std_lat", ctypes.c_double),
        ("rtk_std_hgt", ctypes.c_double),
    ]


def exif_library():
    lib = load_library("ocexif", ["exif_parser.cpp"])
    if lib is not None and not hasattr(lib, "_configured"):
        lib.oc_parse_exif.argtypes = [ctypes.c_char_p, ctypes.POINTER(ExifResult)]
        lib.oc_parse_exif.restype = ctypes.c_int
        lib._configured = True
    return lib


def parse_exif_native(path: str):
    """Parse EXIF/XMP with the native library; None if unavailable/failed."""
    lib = exif_library()
    if lib is None:
        return None
    res = ExifResult()
    rc = lib.oc_parse_exif(path.encode(), ctypes.byref(res))
    if rc != 0:
        return None
    return res
