"""Ray / plane geometry (twin of the two-ray and plane functions of
opencalibration_tpu/ops/intersection.py).

Functions broadcast over leading dims and work under ``torch.func.vmap`` /
``jacfwd``: branches are ``torch.where`` over tensors of the operand's dtype
(a Python-scalar branch gives a float64 tangent under ``jacfwd``).
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.ops.quaternion import _cross, _norm


def ray_intersection(dir1, origin1, dir2, origin2):
    """Midpoint of the closest approach of two rays and the signed squared
    distance between them. Returns (point [..., 3], error [...]): the error
    is negative where the closest approach lies behind either origin; both
    are NaN for near-parallel rays."""
    n1dn1 = torch.sum(dir1 * dir1, dim=-1)
    n1dn2 = torch.sum(dir1 * dir2, dim=-1)
    n2dn2 = torch.sum(dir2 * dir2, dim=-1)
    denom = n1dn1 * n2dn2 - n1dn2 * n1dn2

    offset = origin1 - origin2
    odn1 = torch.sum(offset * dir1, dim=-1)
    odn2 = torch.sum(offset * dir2, dim=-1)

    safe = torch.abs(denom) > 1e-9
    denom_s = torch.where(safe, denom, torch.ones_like(denom))
    t = (n1dn2 * odn2 - n2dn2 * odn1) / denom_s
    s = (n1dn1 * odn2 - n1dn2 * odn1) / denom_s

    p1 = origin1 + t[..., None] * dir1
    p2 = origin2 + s[..., None] * dir2
    mid = 0.5 * (p1 + p2)
    ahead = (t >= 0) & (s >= 0)
    err = torch.sum((p1 - p2) ** 2, dim=-1) * torch.where(ahead, torch.ones_like(t), -torch.ones_like(t))
    return (
        torch.where(safe[..., None], mid, torch.full_like(mid, torch.nan)),
        torch.where(safe, err, torch.full_like(err, torch.nan)),
    )


def corner_plane_to_norm_offset(corners):
    """Plane through 3 corners [..., 3, 3] -> (unit normal [..., 3], a point
    on it [..., 3])."""
    c0 = corners[..., 0, :]
    n = _cross(c0 - corners[..., 1, :], c0 - corners[..., 2, :])
    n = n / torch.clamp_min(_norm(n, keepdim=True), 1e-30)
    return n, c0


def ray_plane_intersection(ray_dir, ray_origin, plane_norm, plane_offset):
    """Returns (point [..., 3], hit [...]); the point is NaN where the ray is
    parallel to the plane."""
    denom = torch.sum(plane_norm * ray_dir, dim=-1)
    hit = torch.abs(denom) >= 1e-9
    denom_s = torch.where(hit, denom, torch.ones_like(denom))
    t = (
        torch.sum(plane_norm * plane_offset, dim=-1) - torch.sum(ray_origin * plane_norm, dim=-1)
    ) / denom_s
    point = ray_origin + t[..., None] * ray_dir
    return torch.where(hit[..., None], point, torch.full_like(point, torch.nan)), hit
