"""Batched multi-scale feature detection + MLDB-style binary description,
Gaussian scale space (twin of opencalibration_tpu/ops/features.py).

Detection is the sigma^4-normalised Hessian determinant over a decimated
octave pyramid with 3x3x3 (x, y, scale) non-maximum suppression and a
fixed-size top-k; description samples (L, Lx, Ly) on 2x2 / 3x3 / 4x4 grids in
the keypoint's oriented frame and compares every intra-grid cell pair:
3 * (6 + 36 + 120) = 486 bits, packed with ``hamming.pack_bits``.

Everything is fixed-shape: images enter as [B, H, W], features leave as
[B, K] arrays with validity masks. Convolutions run in full float32
(``full_fp32``); the reference's ``f32`` blur mode is the one this matches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from opencalibration_tpu_torch.ops.hamming import pack_bits
from opencalibration_tpu_torch.utils.device import full_fp32

NUM_OCTAVES = 4
SUBLEVELS = 4
BASE_SIGMA = 1.6
DETECTOR_THRESHOLD = 1e-4  # on the normalised Hessian response of [0, 1] images
PATCH_RADIUS_SIGMAS = 10.0  # patch half-size in units of keypoint sigma
U8_SCALE = float(np.float32(1.0 / 255.0))  # uint8 -> [0, 1]

_DX = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32) / 8.0
_DY = np.ascontiguousarray(_DX.T)


@functools.lru_cache(maxsize=64)
def _gaussian_taps(sigma: float) -> np.ndarray:
    """Normalised 1-d Gaussian of radius ceil(3 sigma), float32."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img, sigma: float):
    """Separable Gaussian blur of [B, H, W] with edge-replicate padding.

    Replicate padding followed by a valid 1-d convolution is the reference's
    edge-clamped banded Toeplitz product, row by row and then column by
    column."""
    k = torch.as_tensor(_gaussian_taps(float(sigma)), device=img.device)
    r = (k.numel() - 1) // 2
    x = F.pad(img[:, None], (0, 0, r, r), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="replicate")
    return F.conv2d(x, k.view(1, 1, 1, -1))[:, 0]


def _blur_levels(base, base_sigma: float, rels):
    """Every sublevel of one octave blurred directly from the octave base:
    [S, B, H, W]."""
    outs = []
    for rel in rels:
        inc = math.sqrt(max(rel * rel - base_sigma * base_sigma, 0.0))
        outs.append(_blur(base, inc) if inc > 0 else base)
    return torch.stack(outs)


def _kernels(*ks, device):
    return torch.as_tensor(np.stack(ks))[:, None].to(device)  # [C, 1, 3, 3]


def _conv3(img, kernel):
    """[B, H, W] x one 3x3 kernel, edge padding."""
    k = torch.as_tensor(kernel, device=img.device).view(1, 1, 3, 3).to(img.dtype)
    return F.conv2d(F.pad(img[:, None], (1, 1, 1, 1), mode="replicate"), k)[:, 0]


def _conv3_multi(imgs, kernels, groups: int = 1):
    """[B, Cin, H, W] x [Cout, Cin/groups, 3, 3] -> [B, Cout, H, W], edge
    padding, one convolution call."""
    return F.conv2d(
        F.pad(imgs, (1, 1, 1, 1), mode="replicate"), kernels.to(imgs.dtype), groups=groups
    )


def hessian_response(L, sigmas):
    """Scale-normalised determinant of the Hessian per level.

    L [S, B, H, W], sigmas [S] -> [S, B, H, W]. Two multi-channel
    convolutions: L -> (Lx, Ly) -> (Lxx, Lxy, Lyx, Lyy)."""
    S, B, H, W = L.shape
    k1 = _kernels(_DX, _DY, device=L.device)
    k2 = _kernels(_DX, _DY, _DX, _DY, device=L.device)
    g = _conv3_multi(L.reshape(S * B, 1, H, W), k1)
    h = _conv3_multi(g, k2, groups=2)
    Lxx, Lxy, Lyy = h[:, 0], h[:, 1], h[:, 3]
    det = (Lxx * Lyy - Lxy * Lxy).reshape(S, B, H, W)
    s2 = sigmas.to(det.dtype) ** 2
    return (s2 * s2)[:, None, None, None] * det


def _top_k(score, k: int):
    """Top-k of [B, N] rows in (-value, index) order: the k largest values,
    ties broken towards the lower index, which is the order ``lax.top_k``
    gives. ``torch.topk`` leaves ties unordered, so it only fixes the k-th
    value; the set and order are then rebuilt explicitly."""
    B, N = score.shape
    kth = torch.topk(score, k, dim=1).values[:, -1:]
    above = score > kth
    tie = score == kth
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie.to(torch.int32), dim=1) <= need))
    idx = take.nonzero()[:, 1].reshape(B, k)  # ascending index per row
    vals = torch.gather(score, 1, idx)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


def _candidates_from_levels(Rb, threshold, border, k, step):
    """NMS + top-k + subpixel refinement over one stack of same-resolution
    levels. Rb [B, S, H, W]; step: grid spacing in original pixels. Returns
    (xy [B, k, 2] in original pixels, strength, level-in-stack, valid)."""
    B, S, H, W = Rb.shape
    m2 = F.max_pool2d(Rb.reshape(B * S, 1, H, W), 3, stride=1, padding=1).reshape(B, S, H, W)
    neg = torch.full((B, 1, H, W), -torch.inf, dtype=Rb.dtype, device=Rb.device)
    lo = torch.cat([neg, m2[:, :-1]], dim=1)
    hi = torch.cat([m2[:, 1:], neg], dim=1)
    m = torch.maximum(m2, torch.maximum(lo, hi))
    is_peak = (Rb >= m) & (Rb > threshold)
    yy = torch.arange(H, device=Rb.device)
    xx = torch.arange(W, device=Rb.device)
    interior = (
        (yy[:, None] >= border) & (yy[:, None] < H - border)
        & (xx[None, :] >= border) & (xx[None, :] < W - border)
    )
    score = torch.where(is_peak & interior, Rb, -torch.inf)
    k = min(k, S * H * W)
    vals, idx = _top_k(score.reshape(B, S * H * W), k)
    lvl = idx // (H * W)
    rem = idx % (H * W)
    yi = rem // W
    xi = rem % W
    valid = torch.isfinite(vals) & (vals > threshold)

    # subpixel: 2-d quadratic fit on the 3x3 neighbourhood
    yc = torch.clamp(yi, 1, H - 2)
    xc = torch.clamp(xi, 1, W - 2)
    Rf = Rb.reshape(B, S * H * W)
    base_idx = lvl * (H * W) + yc * W + xc

    def n(dy, dx):
        return torch.gather(Rf, 1, base_idx + (dy * W + dx))

    dx = 0.5 * (n(0, 1) - n(0, -1))
    dy = 0.5 * (n(1, 0) - n(-1, 0))
    dxx = n(0, 1) + n(0, -1) - 2.0 * n(0, 0)
    dyy = n(1, 0) + n(-1, 0) - 2.0 * n(0, 0)
    dxy = 0.25 * (n(1, 1) - n(1, -1) - n(-1, 1) + n(-1, -1))
    det = dxx * dyy - dxy * dxy
    det_safe = torch.where(torch.abs(det) < 1e-18, 1.0, det)
    ox = -(dyy * dx - dxy * dy) / det_safe
    oy = -(dxx * dy - dxy * dx) / det_safe
    ok = (torch.abs(det) >= 1e-18) & (torch.abs(ox) <= 0.6) & (torch.abs(oy) <= 0.6)
    x = (xc.to(torch.float32) + torch.where(ok, ox, 0.0)) * step
    y = (yc.to(torch.float32) + torch.where(ok, oy, 0.0)) * step
    return torch.stack([x, y], dim=-1), vals, lvl, valid


def detect(images, max_features: int = 4096, threshold: float = DETECTOR_THRESHOLD):
    """Detect up to max_features keypoints per image of [B, H, W].

    Decimated octave pyramid: each octave runs at half the previous
    resolution and responses are normalised with sigma_rel^4 on the
    decimated grid, which equals the absolute normalisation on the original
    grid. Returns dict with xy [B, K, 2] (x = col, y = row, original
    pixels), strength [B, K], level [B, K] int64, sigma [B, K], valid [B, K].
    """
    images = images.to(torch.float32)
    all_xy, all_vals, all_sig, all_valid, all_lvl = [], [], [], [], []
    base = _blur(images, BASE_SIGMA)
    for o in range(NUM_OCTAVES):
        step = float(2**o)
        Ho, Wo = base.shape[1], base.shape[2]
        if min(Ho, Wo) < 8:
            break
        rels = [BASE_SIGMA * (2.0 ** (s / SUBLEVELS)) for s in range(SUBLEVELS)]
        rels_t = torch.tensor(rels, dtype=torch.float32, device=images.device)
        Lo = _blur_levels(base, BASE_SIGMA, rels)  # [S, B, Ho, Wo]
        cur, cur_rel = Lo[-1], rels[-1]
        Rb = hessian_response(Lo, rels_t).transpose(0, 1)
        border = max(2, int(round(16 / step)))
        k_oct = max(128, max_features // (2**o))
        xy, vals, lvl, valid = _candidates_from_levels(Rb, threshold, border, k_oct, step)
        all_xy.append(xy)
        all_vals.append(vals)
        all_sig.append(rels_t[lvl] * step)  # absolute sigma
        all_valid.append(valid)
        all_lvl.append(lvl + o * SUBLEVELS)  # global level index
        # next octave base: blur to 2 * BASE_SIGMA, then decimate
        nxt = _blur(cur, math.sqrt((2 * BASE_SIGMA) ** 2 - cur_rel**2))
        base = nxt[:, ::2, ::2]

    xy = torch.cat(all_xy, dim=1)
    vals = torch.cat(all_vals, dim=1)
    sig = torch.cat(all_sig, dim=1)
    valid = torch.cat(all_valid, dim=1)
    lvl = torch.cat(all_lvl, dim=1)
    score = torch.where(valid, vals, -torch.inf)
    top_vals, top_idx = _top_k(score, min(max_features, score.shape[1]))

    def take(a):
        return torch.gather(a, 1, top_idx)

    return dict(
        xy=torch.gather(xy, 1, top_idx[..., None].expand(-1, -1, 2)),
        strength=torch.where(torch.isfinite(top_vals), top_vals, 0.0),
        level=take(lvl),
        sigma=take(sig),
        valid=torch.isfinite(top_vals) & (top_vals > threshold),
    )


def _bilinear(img, x, y):
    """Sample img [H, W] at float coords (clamped)."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _mldb_cell_centers():
    """Cell centres of the 2x2 / 3x3 / 4x4 grids in the unit patch frame
    [-1, 1]^2 [29, 2], and the intra-grid cell pairs [162, 2]."""
    centers = []
    pairs = []
    offset = 0
    for g in (2, 3, 4):
        step = 2.0 / g
        for i in range(g):
            for j in range(g):
                centers.append((-1.0 + (i + 0.5) * step, -1.0 + (j + 0.5) * step))
        n = g * g
        for a in range(n):
            for b in range(a + 1, n):
                pairs.append((offset + a, offset + b))
        offset += n
    return np.asarray(centers, np.float32), np.asarray(pairs, np.int64)


_CELL_CENTERS, _CELL_PAIRS = _mldb_cell_centers()
_ORI_OFFSETS = np.asarray(
    [[0.0, 0], [1.0, 0], [-1.0, 0], [0.0, 1], [0.0, -1],
     [0.7, 0.7], [-0.7, 0.7], [0.7, -0.7], [-0.7, -0.7]],
    np.float32,
)


def describe(images, det, patch_scale: float = PATCH_RADIUS_SIGMAS):
    """Oriented MLDB-style 486-bit descriptors.

    images [B, H, W]; det: output of ``detect``. Returns (descriptors
    [B, K, 16] int32 words, angle [B, K])."""
    images = images.to(torch.float32)
    dev = images.device
    L1 = _blur(images, 1.0)
    g = _conv3_multi(L1[:, None], _kernels(_DX, _DY, device=dev))
    B, H, W = images.shape
    # one stacked field: every tap gathers (raw, Lx, Ly) together
    flat = torch.stack([images, g[:, 0], g[:, 1]], dim=-1).reshape(B, H * W, 3)
    batch = torch.arange(B, device=dev)[:, None, None]

    def sample(xs, ys):  # [B, K, S] coords -> [B, K, S, 3]
        xs = torch.clamp(xs, 0.0, W - 1.001)
        ys = torch.clamp(ys, 0.0, H - 1.001)
        x0 = torch.floor(xs).to(torch.int64)
        y0 = torch.floor(ys).to(torch.int64)
        fx = (xs - x0)[..., None]
        fy = (ys - y0)[..., None]
        i00 = y0 * W + x0
        v00 = flat[batch, i00]
        v01 = flat[batch, i00 + 1]
        v10 = flat[batch, i00 + W]
        v11 = flat[batch, i00 + W + 1]
        return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                + v10 * (1 - fx) * fy + v11 * fx * fy)

    xy, sigma = det["xy"], det["sigma"]
    x, y = xy[..., :1], xy[..., 1:2]
    ori = torch.as_tensor(_ORI_OFFSETS, device=dev)
    # orientation: blurred gradient summed over a small disc
    r = sigma[..., None] * 3.0
    go = sample(x + ori[:, 0] * r, y + ori[:, 1] * r)
    angle = torch.atan2(go[..., 2].sum(-1), go[..., 1].sum(-1))
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]

    centers = torch.as_tensor(_CELL_CENTERS, device=dev)
    half = (sigma * patch_scale * 0.5)[..., None]
    cx = centers[:, 0] * half
    cy = centers[:, 1] * half
    v = sample(x + ca * cx - sa * cy, y + sa * cx + ca * cy)  # [B, K, 29, 3]
    vL, vx, vy = v[..., 0], v[..., 1], v[..., 2]
    # gradients in the keypoint frame
    vxr = ca * vx + sa * vy
    vyr = -sa * vx + ca * vy

    a_idx = torch.as_tensor(_CELL_PAIRS[:, 0], device=dev)
    b_idx = torch.as_tensor(_CELL_PAIRS[:, 1], device=dev)
    bits = torch.cat(
        [
            vL[..., a_idx] > vL[..., b_idx],
            vxr[..., a_idx] > vxr[..., b_idx],
            vyr[..., a_idx] > vyr[..., b_idx],
        ],
        dim=-1,
    )  # [B, K, 486]
    return pack_bits(bits), angle


def extract_features(images, max_features: int = 4096, threshold: float = DETECTOR_THRESHOLD):
    """Detect + describe a [B, H, W] batch: float in [0, 1] or uint8.

    Returns dict(xy, strength, sigma, level, valid, angle, descriptors)."""
    if images.dtype == torch.uint8:
        # the product with float32(1 / 255), as XLA compiles the reference's
        # division: a true division differs in the last bit on a third of the pixels
        images = images.to(torch.float32) * U8_SCALE
    with full_fp32():
        det = detect(images, max_features=max_features, threshold=threshold)
        desc, angle = describe(images, det)
    return dict(
        xy=det["xy"],
        strength=det["strength"],
        sigma=det["sigma"],
        level=det["level"],
        valid=det["valid"],
        angle=angle,
        descriptors=desc,
    )
