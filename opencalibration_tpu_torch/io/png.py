"""PNG encoder / decoder for 8-bit images, on ``zlib`` and ``struct``.

Arrays use OpenCV's channel order, so ``encode_png`` / ``decode_png`` stand in
for ``cv2.imencode(".png", img)`` / ``cv2.imdecode(buf, IMREAD_UNCHANGED)``:
a [H, W] array is a gray file, [H, W, 3] is B, G, R in memory and R, G, B in
the file, [H, W, 4] is B, G, R, A in memory and R, G, B, A in the file. A
3-channel Lab thumbnail therefore round-trips unchanged, and either package
reads the other's files.

The writer uses filter 0 (None) on every row. The reader handles the five
filters of non-interlaced 8- and 16-bit files of colour types 0 (gray), 2
(RGB) and 6 (RGBA).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _swap_rb(img: np.ndarray) -> np.ndarray:
    """B, G, R[, A] <-> R, G, B[, A] along the last axis."""
    if img.ndim == 3 and img.shape[2] >= 3:
        order = [2, 1, 0] + list(range(3, img.shape[2]))
        return img[..., order]
    return img


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W], [H, W, 1], [H, W, 3] (BGR) or [H, W, 4] (BGRA) -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, got {c}")
    rows = np.zeros((h, 1 + w * c), np.uint8)  # leading filter byte 0 per row
    rows[:, 1:] = _swap_rb(img).reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    """Vectorised Paeth predictor over int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = raw[y, 0]
        line = raw[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 2:
            cur = line + prev  # uint8 wraps modulo 256
        elif ft == 1:
            # Sub: a running sum per byte lane, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.uint32), axis=0).astype(np.uint8).reshape(-1)
        elif ft in (3, 4):
            cur = np.zeros(stride, np.uint8)
            lanes = line.reshape(-1, bpp)
            up = prev.reshape(-1, bpp).astype(np.int16)
            left = np.zeros(bpp, np.int16)
            upleft = np.zeros(bpp, np.int16)
            res = cur.reshape(-1, bpp)
            for x in range(lanes.shape[0]):
                if ft == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], upleft)
                left = (lanes[x].astype(np.int16) + pred) & 0xFF
                upleft = up[x]
                res[x] = left
        else:
            raise ValueError(f"PNG filter type {ft} is not defined")
        out[y] = cur
        prev = cur
    return out


def decode_png(data) -> Optional[np.ndarray]:
    """PNG bytes -> [H, W] (gray), [H, W, 3] (BGR) or [H, W, 4] (BGRA), uint8
    for an 8-bit file and uint16 for a 16-bit one, as ``IMREAD_UNCHANGED``
    gives them; None when the bytes are no PNG. An interlaced or paletted
    file raises ``ValueError``."""
    data = bytes(data)
    if data[:8] != SIGNATURE:
        return None
    pos = 8
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        return None
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"decode_png reads non-interlaced 8- or 16-bit gray / RGB / RGBA files, got depth {depth}, "
            f"colour type {ctype}, interlace {interlace}"
        )
    c = _CHANNELS[ctype]
    nbytes = depth // 8
    stride = w * c * nbytes
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        return None
    img = _unfilter(raw.reshape(h, stride + 1), h, stride, c * nbytes)
    if nbytes == 2:  # big-endian samples
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(h, w, c)
    return np.ascontiguousarray(_swap_rb(img) if c > 1 else img[..., 0])
