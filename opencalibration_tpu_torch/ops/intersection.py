"""Ray / plane / triangle geometry (twin of
opencalibration_tpu/ops/intersection.py).

Functions broadcast over leading dims and work under ``torch.func.vmap`` /
``jacfwd``: branches are ``torch.where`` over tensors of the operand's dtype
(a Python-scalar branch gives a float64 tangent under ``jacfwd``).
``ray_intersection_pixels`` takes one pair of pixels; ``triangulate_tracks``
solves every track of a batch at once.
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.ops.distort import image_from_3d_world, image_to_3d
from opencalibration_tpu_torch.ops.quaternion import _cross, _norm, quat_rotate


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


def ray_intersection_pixels(model1, model2, pos1, pos2, quat1, quat2, px1, px2, iters: int = 20):
    """Two-pixel triangulation: the two rays' closest-approach midpoint (the
    midpoint of the camera positions for parallel rays), then ``iters``
    Levenberg-Marquardt steps on the stacked pixel residuals of the 3-d
    point. Returns (point [3], final cost 0.5 |r|^2)."""
    r1 = quat_rotate(quat1, image_to_3d(px1, model1))
    r2 = quat_rotate(quat2, image_to_3d(px2, model2))
    p0, _ = ray_intersection(r1, pos1, r2, pos2)
    p = torch.where(torch.all(torch.isfinite(p0)), p0, 0.5 * (pos1 + pos2))

    def resid(point):
        e1 = image_from_3d_world(point, model1, pos1, quat1) - px1
        e2 = image_from_3d_world(point, model2, pos2, quat2) - px2
        return torch.cat([e1, e2])

    def cost(point):
        r = resid(point)
        return 0.5 * torch.sum(r * r)

    lam = torch.tensor(1e-6, dtype=px1.dtype, device=px1.device)
    for _ in range(iters):
        r = resid(p)
        J = torch.func.jacfwd(resid)(p)  # [4, 3]
        JtJ = J.T @ J
        g = J.T @ r
        A = JtJ + lam * torch.diag(torch.clamp_min(torch.diagonal(JtJ), 1e-12))
        p_new = p - torch.linalg.solve(A, g)
        c_new = cost(p_new)
        ok = torch.isfinite(c_new) & (c_new < cost(p))
        p = torch.where(ok, p_new, p)
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 3.0), 1e-12, 1e8)
    return p, cost(p)


def point_inside_triangle(point, corners):
    """Same side of each edge as the opposite corner: point [..., 3],
    corners [..., 3, 3] -> [...] bool."""
    inside = torch.ones(point.shape[:-1], dtype=torch.bool, device=point.device)
    for i in range(3):
        v0 = corners[..., i, :]
        edge = corners[..., (i + 1) % 3, :] - v0
        raw = corners[..., (i + 2) % 3, :] - v0
        perp = raw - edge * (torch.sum(raw * edge, dim=-1) / torch.clamp_min(torch.sum(edge * edge, dim=-1), 1e-30))[..., None]
        inside = inside & (torch.sum((point - v0) * perp, dim=-1) >= 0)
    return inside


def ray_triangle_intersection(ray_dir, ray_origin, corners):
    """Returns (point on the triangle's plane [..., 3], hit [...]): hit where
    the ray meets the plane inside the triangle."""
    norm, offset = corner_plane_to_norm_offset(corners)
    point, hit = ray_plane_intersection(ray_dir, ray_origin, norm, offset)
    inside = point_inside_triangle(torch.where(hit[..., None], point, torch.zeros_like(point)), corners)
    return point, hit & inside


def triangulate_tracks(ray_dirs, origins, valid):
    """Least-squares point nearest to every valid ray of each track (closed
    form, N rays). ray_dirs, origins [T, R, 3]; valid [T, R]. Returns
    (points [T, 3], mean squared perpendicular distance [T]); NaN for tracks
    with fewer than two valid rays."""
    d = ray_dirs / torch.clamp_min(_norm(ray_dirs, keepdim=True), 1e-30)
    w = valid.to(ray_dirs.dtype)
    eye = torch.eye(3, dtype=ray_dirs.dtype, device=ray_dirs.device)
    A_i = eye - d[..., :, None] * d[..., None, :]  # I - d d^T per ray
    A = torch.sum(w[..., None, None] * A_i, dim=1)
    b = torch.sum(w[..., None] * torch.einsum("trij,trj->tri", A_i, origins), dim=1)
    n_valid = torch.sum(w, dim=1)
    ok = n_valid >= 2
    reg = 1e-12 + torch.where(ok, torch.zeros_like(n_valid), torch.ones_like(n_valid))
    p = torch.linalg.solve(A + reg[..., None, None] * eye, b[..., None])[..., 0]
    diff = p[:, None, :] - origins
    perp = diff - d * torch.sum(diff * d, dim=-1, keepdim=True)
    msd = torch.sum(w * torch.sum(perp * perp, dim=-1), dim=1) / torch.clamp_min(n_valid, 1.0)
    return (torch.where(ok[..., None], p, torch.full_like(p, torch.nan)),
            torch.where(ok, msd, torch.full_like(msd, torch.nan)))
