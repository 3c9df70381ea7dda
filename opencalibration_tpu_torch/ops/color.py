"""8-bit colour conversions and area resize, without OpenCV.

The JAX package calls ``cv2.cvtColor(..., COLOR_BGR2Lab / COLOR_Lab2BGR)`` and
``cv2.resize(..., INTER_AREA)`` for its Lab thumbnails, its full-resolution
Lab working images and the BGR its orthomosaics are written in. These
functions reproduce OpenCV's 8-bit methods in integers, so the port gives the
same pixels on a machine without OpenCV, and uses them whether or not OpenCV
is installed:

* ``bgr_to_lab_u8``: sRGB gamma table (3 fractional bits), 12-bit matrix into
  D65-normalised XYZ, cube-root table (15 fractional bits), rounded shifts.
* ``lab_u8_to_bgr``: the integer inverse (L -> y and f(y) table, a / b offsets
  in 14 fractional bits, f^-1 table, 12-bit matrix, inverse-gamma table of
  4096 entries). It takes a numpy array or a tensor on any device, so a
  rendered tile converts where it lies.
* ``resize_area``: box-sum with rounding for integer factors, fractional pixel
  coverage weights in float32 for other reductions, and 11-bit fixed-point
  linear interpolation where a side grows.

tests/test_torch_color_png.py holds all three against OpenCV and states how
far they may part.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_CBRT_TAB_SIZE = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)

# linear sRGB -> XYZ (D65) and back, rows X, Y, Z over columns R, G, B
_RGB2XYZ = np.array([
    [0.412453, 0.357580, 0.180423],
    [0.212671, 0.715160, 0.072169],
    [0.019334, 0.119193, 0.950227],
])
_XYZ2RGB = np.array([
    [3.240479, -1.53715, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])
_WHITE = np.array([0.950456, 1.0, 1.088754])

_BASE_SHIFT = 14
_BASE = 1 << _BASE_SHIFT
_INV_GAMMA_SIZE = 1 << 12
_MIN_AB = -8145
_AB_TAB_SIZE = _BASE * 9 // 4


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _round_half_even(x):
    return np.rint(x).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _forward_tables():
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma = _round_half_even(255.0 * (1 << _GAMMA_SHIFT) * lin)
    # the cube-root table is built in float32, as OpenCV builds it
    x = np.arange(_CBRT_TAB_SIZE, dtype=np.float32) * np.float32(1.0 / (255.0 * (1 << _GAMMA_SHIFT)))
    f = np.where(x < np.float32(0.008856), x * np.float32(7.787) + np.float32(16.0 / 116.0), np.cbrt(x))
    cbrt = _round_half_even((np.float32(1 << _LAB_SHIFT2) * f.astype(np.float32)).astype(np.float64))
    coeffs = _round_half_even((1 << _LAB_SHIFT) * _RGB2XYZ / _WHITE[:, None])
    return gamma.astype(np.int32), cbrt.astype(np.int32), coeffs.astype(np.int32)


def bgr_to_lab_u8(bgr: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 BGR -> [..., 3] uint8 Lab (L * 255 / 100, a + 128,
    b + 128), as ``cv2.cvtColor(bgr, cv2.COLOR_BGR2Lab)`` on 8-bit input."""
    gamma, cbrt, c = _forward_tables()
    B = gamma[bgr[..., 0]]
    G = gamma[bgr[..., 1]]
    R = gamma[bgr[..., 2]]
    fx = cbrt[_descale(R * c[0, 0] + G * c[0, 1] + B * c[0, 2], _LAB_SHIFT)]
    fy = cbrt[_descale(R * c[1, 0] + G * c[1, 1] + B * c[1, 2], _LAB_SHIFT)]
    fz = cbrt[_descale(R * c[2, 0] + G * c[2, 1] + B * c[2, 2], _LAB_SHIFT)]
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(l_scale * fy + l_shift, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    b = _descale(200 * (fy - fz) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], axis=-1), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _inverse_tables():
    i = np.arange(256, dtype=np.float64)
    # L (0..255 for 0..100) -> y and f(y), both scaled by BASE
    fy_hi = i * 100.0 * _BASE / (255.0 * 116.0) + 16.0 * _BASE / 116.0
    y_hi = fy_hi * fy_hi * fy_hi / (_BASE * _BASE)
    y_lo = i * (100.0 / 255.0) / (24389.0 / 27.0) * _BASE
    fy_lo = _BASE * (16.0 / 116.0 + (841.0 / 108.0) * (i * (100.0 / 255.0) / (24389.0 / 27.0)))
    low = i <= 20
    y = _round_half_even(np.where(low, y_lo, y_hi))
    ify = _round_half_even(np.where(low, fy_lo, fy_hi))
    # f^-1 over f * BASE in [MIN_AB, MIN_AB + size)
    v = np.arange(_MIN_AB, _MIN_AB + _AB_TAB_SIZE, dtype=np.int64)
    lin = _floor_div_c(v * 108, 841) - _BASE * 16 // 116 * 108 // 841
    cube = _floor_div_c(_floor_div_c(v * v, _BASE) * v, _BASE)
    ab = np.where(v <= 3390, lin, cube)
    x = np.arange(_INV_GAMMA_SIZE, dtype=np.float64) / _INV_GAMMA_SIZE
    g = np.where(x <= 0.0031308, x * 12.92, 1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    inv_gamma = _round_half_even(255.0 * g)
    coeffs = _round_half_even((1 << _LAB_SHIFT) * _XYZ2RGB * _WHITE[None, :])
    return (y.astype(np.int32), ify.astype(np.int32), ab.astype(np.int32),
            inv_gamma.astype(np.int32), coeffs.astype(np.int32))


def _floor_div_c(a, b):
    """C integer division (truncation toward zero) of int64 arrays."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


@functools.lru_cache(maxsize=None)
def _inverse_tables_on(device_str: str):
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device_str) for t in _inverse_tables())


def _lab_to_bgr_int(L, a, b, tabs, xp):
    """Shared integer body; ``L, a, b`` are int64 arrays / tensors, ``xp`` is
    numpy or torch (only ``clip``/``clamp`` differ)."""
    ytab, ifytab, abtab, inv_gamma, c = tabs
    y = ytab[L]
    ify = ifytab[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    x = abtab[ify + adiv - _MIN_AB]
    z = abtab[ify - bdiv - _MIN_AB]
    shift = _LAB_SHIFT + (_BASE_SHIFT - 12)
    out = []
    for row in (2, 1, 0):  # B, G, R
        v = _descale(c[row, 0] * x + c[row, 1] * y + c[row, 2] * z, shift)
        v = xp.clip(v, 0, _INV_GAMMA_SIZE - 1) if xp is np else torch.clamp(v, 0, _INV_GAMMA_SIZE - 1)
        out.append(inv_gamma[v])
    return out


def lab_u8_to_bgr(lab):
    """[..., 3] uint8 Lab -> [..., 3] uint8 BGR, as
    ``cv2.cvtColor(lab, cv2.COLOR_Lab2BGR)`` on 8-bit input. A tensor is
    converted on its own device and a tensor comes back."""
    if isinstance(lab, torch.Tensor):
        tabs = _inverse_tables_on(str(lab.device))
        v = lab.to(torch.int64)
        out = _lab_to_bgr_int(v[..., 0], v[..., 1], v[..., 2], tabs, torch)
        return torch.stack(out, dim=-1).to(torch.uint8)
    tabs = tuple(t.astype(np.int64) for t in _inverse_tables())
    v = np.asarray(lab).astype(np.int64)
    out = _lab_to_bgr_int(v[..., 0], v[..., 1], v[..., 2], tabs, np)
    return np.stack(out, axis=-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# area resize
# ---------------------------------------------------------------------------

def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 coverage weights of OpenCV's area table for a
    downscale by src / dst."""
    scale = src / dst
    W = np.zeros((dst, src), np.float32)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1 = math.ceil(f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            W[d, s1 - 1] = np.float32((s1 - f1) / cell)
        W[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            W[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return W


_COEF_BITS = 11  # OpenCV's fixed-point interpolation coefficients


def _linear_taps(src: int, dst: int):
    """Source index [dst] and 11-bit weights [dst, 2] of OpenCV's INTER_AREA
    when it does not shrink both sides: linear interpolation at area-aligned
    positions, the fraction held in float32."""
    scale = src / dst
    inv = dst / src
    idx = np.zeros(dst, np.int64)
    wgt = np.zeros((dst, 2), np.int64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s < 0:
            s, f = 0, np.float32(0.0)
        if s >= src - 1:
            s, f = src - 1, np.float32(0.0)
        idx[d] = s
        wgt[d] = (int(np.rint((np.float32(1.0) - f) * np.float32(1 << _COEF_BITS))),
                  int(np.rint(f * np.float32(1 << _COEF_BITS))))
    return idx, wgt


def _resize_linear_area(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    sh, sw = img.shape[:2]
    xi, xw = _linear_taps(sw, dw)
    yi, yw = _linear_taps(sh, dh)
    src = img.astype(np.int64).reshape(sh, sw, -1)
    x1 = np.minimum(xi + 1, sw - 1)
    rows = src[:, xi] * xw[None, :, :1] + src[:, x1] * xw[None, :, 1:]  # [sh, dw, C], 11 fractional bits
    y1 = np.minimum(yi + 1, sh - 1)
    out = (((yw[:, None, :1] * (rows[yi] >> 4)) >> 16) + ((yw[:, None, 1:] * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def resize_area(img: np.ndarray, size_wh) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> (height, width) = size_wh[::-1], as
    ``cv2.resize(img, size_wh, interpolation=cv2.INTER_AREA)``."""
    dw, dh = int(size_wh[0]), int(size_wh[1])
    sh, sw = img.shape[:2]
    if (dh, dw) == (sh, sw):
        return img.copy()
    if sh % dh == 0 and sw % dw == 0:
        fy, fx = sh // dh, sw // dw
        blocks = img.reshape((dh, fy, dw, fx) + img.shape[2:]).astype(np.int64).sum(axis=(1, 3))
        area = fy * fx
        if (fy, fx) == (2, 2):
            return ((blocks + 2) >> 2).astype(np.uint8)
        return np.rint(blocks.astype(np.float32) * np.float32(1.0 / area)).astype(np.uint8)
    if dh > sh or dw > sw:
        return _resize_linear_area(img, dw, dh)
    wy = _area_weights(sh, dh)
    wx = _area_weights(sw, dw)
    src = img.astype(np.float32)
    rows = np.tensordot(wx, src, axes=([1], [1]))  # [dw, sh, ...]
    out = np.tensordot(wy, rows, axes=([1], [1]))  # [dh, dw, ...]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
