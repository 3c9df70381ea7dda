"""JPEG decoding and encoding on the host, through the port's own codec
(``native/jpeg.cpp``, built with g++ on first use), so a machine without
OpenCV or PIL reads and writes the files.

``decode_jpeg`` equals ``cv2.imread(path, IMREAD_COLOR)`` (libjpeg-turbo's
integer IDCT, fancy upsampling and colour tables, the EXIF orientation
applied) for baseline, extended and progressive Huffman-coded files; a
one-component file decodes to [H, W] gray, which ``IMREAD_COLOR`` would
replicate into three channels. ``encode_jpeg`` writes the bytes of
``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``: baseline,
4:2:0 for three channels, the standard Huffman tables. Arrays use OpenCV's
channel order (B, G, R). The codec has no fallback: if it cannot be built,
the error carries the compiler's messages.

ctypes releases the GIL for the duration of each call, so a thread pool
decodes in parallel. Each native call is timed under the performance
counters' ``jpeg: decode`` and ``jpeg: encode`` keys.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from opencalibration_tpu_torch.native import jpeg_library
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

JPEG_MAGIC = b"\xff\xd8"
_MALFORMED, _UNSUPPORTED = 1, 2


def decode_jpeg(data) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3] BGR (three components) or [H, W] gray
    (one); None for bytes that are no readable JPEG. A file the codec does
    not cover (arithmetic coding, lossless, 12-bit, CMYK, other sampling
    factors) raises ``ValueError``."""
    data = bytes(data)
    lib = jpeg_library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.oc_jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc == _UNSUPPORTED:
        raise ValueError("JPEG variant not supported: only 8-bit Huffman-coded baseline, extended and "
                         "progressive files with 1 or 3 components and 1x1 chroma")
    if rc != 0:
        return None
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    with PerformanceMeasure("jpeg: decode"):
        rc = lib.oc_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes)
    return out if rc == 0 else None


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W], [H, W, 1] or [H, W, 3] (BGR) -> baseline JPEG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes 1 or 3 channels, got shape {img.shape}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    lib = jpeg_library()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    with PerformanceMeasure("jpeg: encode"):
        rc = lib.oc_jpeg_encode(img.ctypes.data, w, h, channels, int(quality), ctypes.byref(buf),
                                ctypes.byref(size))
    if rc != 0:
        raise ValueError(f"encode_jpeg cannot write a {w} x {h} image with {channels} channels")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.oc_jpeg_free(buf)
