"""The benchmark's own JPEG encoder: ``native/jpeg_encode.cpp``, built by g++
into ``ocbench/.build/`` under a hash of its source on first use and bound
with ctypes. ctypes releases the GIL during the call, so a thread pool
encodes in parallel."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "native", "jpeg_encode.cpp")
BUILD_DIR = os.path.join(_HERE, ".build")
_lock = threading.Lock()
_lib = None


def _build() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libocbench_jpeg_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"building {out} failed: {' '.join(cmd)}\n{done.stderr}")
    os.replace(tmp, out)
    return out


def library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.oc_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
            lib.oc_jpeg_encode.restype = ctypes.c_int
            lib.oc_jpeg_free.argtypes = [u8p]
            lib.oc_jpeg_free.restype = None
            _lib = lib
        return _lib


def encode_jpeg(img: np.ndarray, quality: int) -> bytes:
    """uint8 [H, W] gray or [H, W, 3] BGR -> baseline JPEG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 [H, W] or [H, W, 3], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    lib = library()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.oc_jpeg_encode(img.ctypes.data, w, h, 1 if img.ndim == 2 else 3, int(quality), ctypes.byref(buf),
                            ctypes.byref(size))
    if rc != 0:
        raise ValueError(f"encode_jpeg cannot write a {w} x {h} image")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.oc_jpeg_free(buf)
