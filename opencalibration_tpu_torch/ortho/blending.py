"""Blend weights, pull-push fill and Laplacian pyramid blending (twin of
opencalibration_tpu/ortho/blending.py).

The pyramid is separable 5-tap Gaussian convolutions over a [L, H, W, C]
layer batch, reshuffled to [L * C, 1, H, W] so every layer and channel of a
pyramid level is one convolution call. Every function follows the device of
the tensors it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def compute_blend_weight(pixel_x, pixel_y, image_width, image_height, camera_distance):
    """Edge-feather x center-preference x proximity product
    (reference blending.cpp:12-36). Broadcasts over tensors."""
    half_w = image_width * 0.5
    half_h = image_height * 0.5
    min_edge = torch.minimum(
        torch.minimum(pixel_x, image_width - 1.0 - pixel_x),
        torch.minimum(pixel_y, image_height - 1.0 - pixel_y),
    )
    edge_weight = torch.clamp(min_edge / half_w, max=1.0).clamp(min=0.001)
    cx = (pixel_x - half_w) / half_w
    cy = (pixel_y - half_h) / half_h
    center_dist = torch.sqrt(cx * cx + cy * cy)
    center_weight = 1.0 - 0.5 * torch.clamp(center_dist, max=1.0)
    proximity = 1.0 / (1.0 + camera_distance * camera_distance)
    return edge_weight * center_weight * proximity


def _sep_conv(img, k):
    """[N, H, W, C] separable convolution with edge-replicating padding;
    ``k`` is a sequence of odd length."""
    n, h, w, c = img.shape
    kt = torch.tensor(k, dtype=img.dtype, device=img.device)
    r = len(k) // 2
    x = img.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), kt.reshape(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), kt.reshape(1, 1, -1, 1))
    return x.reshape(n, c, h, w).permute(0, 2, 3, 1)


def pyr_down(img):
    """[N, H, W, C] -> [N, ceil(H/2), ceil(W/2), C]."""
    return _sep_conv(img, _GAUSS5)[:, ::2, ::2, :]


def pyr_up(img, out_hw):
    """[N, h, w, C] -> [N, H, W, C] (zero-stuff + 2x gaussian)."""
    n, h, w, c = img.shape
    H, W = out_hw
    up = torch.zeros((n, h * 2, w * 2, c), dtype=img.dtype, device=img.device)
    up[:, ::2, ::2, :] = img
    up = _sep_conv(up, tuple(2.0 * g for g in _GAUSS5))
    return up[:, :H, :W, :]


def _num_levels(h, w, max_levels=None):
    levels = 1
    while min(h, w) >> levels >= 2:
        levels += 1
    if max_levels:
        levels = min(levels, max_levels)
    return levels


def pull_push_fill(color, weight):
    """Extrapolate valid colors into zero-weight regions
    (reference blending.cpp:38-89): weighted pyramid down, then fill
    invalid pixels from coarser levels on the way up.

    color: [N, H, W, C], weight: [N, H, W, 1]."""
    n, h, w, c = color.shape
    levels = _num_levels(h, w)
    wc = [color * weight]
    ws = [weight]
    for _ in range(1, levels):
        wc.append(pyr_down(wc[-1]))
        ws.append(pyr_down(ws[-1]))
    out = wc[-1] / torch.clamp_min(ws[-1], 1e-8)  # normalize coarsest
    for l in range(levels - 2, -1, -1):
        up = pyr_up(out, wc[l].shape[1:3])
        cur = wc[l] / torch.clamp_min(ws[l], 1e-8)
        out = torch.where(ws[l] > 1e-6, cur, up)
    return out


def laplacian_blend(colors, weights, levels: int = 5):
    """Weight-renormalized multi-band blend (reference blending.cpp:91-229).

    colors: [L, H, W, C] layers (already hole-filled), weights: [L, H, W, 1].
    Returns [H, W, C]."""
    wsum = torch.sum(weights, dim=0, keepdim=True)
    wnorm = weights / torch.clamp_min(wsum, 1e-8)

    # gaussian pyramid of weights and of colors (the laplacian is taken below)
    gp_w = [wnorm]
    gp_c = [colors]
    for _ in range(1, levels):
        gp_w.append(pyr_down(gp_w[-1]))
        gp_c.append(pyr_down(gp_c[-1]))

    # blend from coarsest up
    blended = torch.sum(gp_c[-1] * gp_w[-1], dim=0)
    for l in range(levels - 2, -1, -1):
        hw = gp_c[l].shape[1:3]
        lap = gp_c[l] - pyr_up(gp_c[l + 1], hw)
        band = torch.sum(lap * gp_w[l], dim=0)
        blended = pyr_up(blended[None], hw)[0] + band
    return blended


def sigmoid_transition_weight(raw_weight, best_weight, transition_radius: float):
    """Sigmoid of weight margin vs the per-pixel best layer (the blend
    transition radius sharpening of reference ortho.cpp:1839-1875)."""
    margin = (raw_weight - best_weight) / max(transition_radius, 1e-6)
    return torch.sigmoid(margin * 6.0)
