"""Projection and Brown distortion (twin of opencalibration_tpu/ops/distort.py).

Functions broadcast over leading dimensions: a pixel [..., 2] goes with a
camera whose leaves broadcast against ``...`` (a single camera's 0-d focal
broadcasts against anything). Inverse problems are fixed-iteration Newton
loops, as in the reference, so shapes and control flow are static; the
FORWARD <-> INVERSE model conversions are fixed-iteration 5-parameter LM fits,
counted under the performance event ``model fits``; with the performance
counters on, a fit of a model that the current job already fitted in the
same direction, dtype and device is also counted under ``model fit repeats``.
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.ops.quaternion import quat_rotate, quat_rotate_inverse
from opencalibration_tpu_torch.types.camera import FORWARD, INVERSE, CameraModel
from opencalibration_tpu_torch.utils import performance
from opencalibration_tpu_torch.utils.device import full_fp32

MIN_PROJECTION_Z = 1e-3
_UNDISTORT_ITERS = 10


def distort_projected_ray(xy, radial, tangential):
    """Brown radial (k1, k2, k3) + tangential (p1, p2) forward distortion of
    a projected ray xy [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, k3 = radial[..., 0], radial[..., 1], radial[..., 2]
    p1, p2 = tangential[..., 0], tangential[..., 1]
    radial_factor = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xy_prod2 = 2.0 * x * y
    dx = radial_factor * x + xy_prod2 * p1 + p2 * (r2 + 2.0 * x * x)
    dy = radial_factor * y + xy_prod2 * p2 + p1 * (r2 + 2.0 * y * y)
    return torch.stack([dx, dy], dim=-1)


def undistort_iterative(target_xy, radial, tangential, iters: int = _UNDISTORT_ITERS):
    """Solve distort_projected_ray(u) == target_xy for u [..., 2].

    Fixed-iteration damped Newton on each 2x2 system. The Jacobian columns
    come from forward-mode derivatives along x and y, as ``jax.jacfwd`` takes
    them in the reference."""
    def resid(u):
        return distort_projected_ray(u, radial, tangential) - target_xy

    ex = torch.zeros_like(target_xy)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(target_xy)
    ey[..., 1] = 1.0
    u = target_xy
    for _ in range(iters):
        r, j0 = torch.func.jvp(resid, (u,), (ex,))  # j0 = dr/du_x [..., 2]
        _, j1 = torch.func.jvp(resid, (u,), (ey,))
        # J = [[j0x, j1x], [j0y, j1y]]; A = J^T J + damping, g = J^T r
        a00 = j0[..., 0] * j0[..., 0] + j0[..., 1] * j0[..., 1] + 1e-12
        a01 = j0[..., 0] * j1[..., 0] + j0[..., 1] * j1[..., 1]
        a10 = j1[..., 0] * j0[..., 0] + j1[..., 1] * j0[..., 1]
        a11 = j1[..., 0] * j1[..., 0] + j1[..., 1] * j1[..., 1] + 1e-12
        g0 = j0[..., 0] * r[..., 0] + j0[..., 1] * r[..., 1]
        g1 = j1[..., 0] * r[..., 0] + j1[..., 1] * r[..., 1]
        det = a00 * a11 - a01 * a10
        du = torch.stack(
            [(a11 / det) * g0 + (-a01 / det) * g1, (-a10 / det) * g0 + (a00 / det) * g1],
            dim=-1,
        )
        u_new = u - du
        # reject non-finite updates (degenerate Jacobian)
        u = torch.where(torch.isfinite(u_new).all(dim=-1, keepdim=True), u_new, u)
    return u


def project_planar(ray):
    """Planar projection with the z >= MIN_PROJECTION_Z clamp."""
    z = torch.clamp_min(ray[..., 2], MIN_PROJECTION_Z)
    return ray[..., :2] / z[..., None]


def _normalize_homogeneous(xy):
    """[x, y] -> unit-norm [x, y, 1]."""
    h = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return h / torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True))


def image_to_3d(pixel, model: CameraModel):
    """Pixel [..., 2] -> unit ray in the camera frame [..., 3].

    FORWARD model: iterative undistort; INVERSE model: coefficients applied
    directly."""
    unprojected = (pixel - model.principal_point) / model.focal_length_pixels[..., None]
    if model.tag == FORWARD:
        undistorted = undistort_iterative(
            unprojected, model.radial_distortion, model.tangential_distortion
        )
    else:
        undistorted = distort_projected_ray(
            unprojected, model.radial_distortion, model.tangential_distortion
        )
    return _normalize_homogeneous(undistorted)


def image_from_3d(ray, model: CameraModel):
    """Camera-frame ray/point [..., 3] -> pixel [..., 2].

    FORWARD model: project + distort; INVERSE model: project + iterative
    solve."""
    projected = project_planar(ray)
    if model.tag == FORWARD:
        distorted = distort_projected_ray(
            projected, model.radial_distortion, model.tangential_distortion
        )
    else:
        distorted = undistort_iterative(
            projected, model.radial_distortion, model.tangential_distortion
        )
    return distorted * model.focal_length_pixels[..., None] + model.principal_point


def image_to_3d_world(pixel, model: CameraModel, camera_pos, camera_quat):
    """Pixel -> (world ray direction, origin)."""
    return quat_rotate(camera_quat, image_to_3d(pixel, model)), camera_pos


def image_from_3d_world(point, model: CameraModel, camera_pos, camera_quat):
    """World point -> pixel."""
    return image_from_3d(quat_rotate_inverse(camera_quat, point - camera_pos), model)


# ---------------------------------------------------------------------------
# Forward <-> inverse model conversion
# ---------------------------------------------------------------------------

_CONVERT_GRID = 20
_FIT_ITERATIONS = 50


def _lm_fit_5param(resid_fn, p0, iters: int = _FIT_ITERATIONS):
    """Dense Levenberg-Marquardt over 5 parameters with a fixed iteration
    count: every step is taken on the device and none waits for the host."""
    def cost(p):
        r = resid_fn(p)
        return torch.sum(r * r)

    p = p0
    lam = torch.tensor(1e-4, dtype=p0.dtype, device=p0.device)
    with full_fp32():
        for _ in range(iters):
            r = resid_fn(p)
            J = torch.func.jacfwd(resid_fn)(p)  # [R, 5]
            JtJ = J.T @ J
            g = J.T @ r
            A = JtJ + lam * torch.diag(torch.clamp_min(torch.diagonal(JtJ), 1e-12))
            p_new = p - torch.linalg.solve_ex(A, g)[0]
            c_new = cost(p_new)
            ok = torch.isfinite(c_new) & (c_new < cost(p))
            p = torch.where(ok, p_new, p)
            lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 3.0), 1e-12, 1e10)
    return p


def _pixel_grid(model: CameraModel, divisions: int = _CONVERT_GRID):
    """[(d + 1)^2, 2] pixels on a regular grid spanning the image."""
    u = torch.arange(divisions + 1, dtype=model.dtype, device=model.focal_length_pixels.device)
    u = u / divisions
    gx, gy = torch.meshgrid(u * model.pixels_cols, u * model.pixels_rows, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def _with_distortion(model: CameraModel, params) -> CameraModel:
    return model.replace(radial_distortion=params[:3], tangential_distortion=params[3:])


def _count_fit(direction: str, model: CameraModel):
    """Count one model fit, and whether it repeats one of the current job's
    (bit-equal leaves: focal, principal point, distortion, size). The leaves
    are read to the host only while the counters are on."""
    performance.add_event_count("model fits", 1.0)
    if performance.counters_enabled():
        leaves = [model.focal_length_pixels, model.principal_point, model.radial_distortion,
                  model.tangential_distortion, model.pixels_cols, model.pixels_rows]
        values = torch.cat([x.detach().reshape(-1).to("cpu", torch.float64) for x in leaves]).numpy().tobytes()
        key = ("model fit", direction, model.dtype, model.focal_length_pixels.device, values)
        if performance.repeat_in_job(key):
            performance.add_event_count("model fit repeats", 1.0)


def convert_to_inverse(model: CameraModel) -> CameraModel:
    """An INVERSE model matching a single FORWARD model over a pixel grid:
    the 5 distortion parameters fitted on 3-d ray residuals, on the model's
    device and dtype."""
    if model.tag != FORWARD:
        raise ValueError("convert_to_inverse takes a FORWARD model")
    pixels = _pixel_grid(model)
    rays = image_to_3d(pixels, model)
    repro = image_from_3d(rays, model)  # exact forward reprojection
    base = model.with_tag(INVERSE)

    def resid(params):
        return (image_to_3d(repro, _with_distortion(base, params)) - rays).reshape(-1)

    _count_fit(INVERSE, model)
    p = _lm_fit_5param(resid, torch.zeros(5, dtype=model.dtype, device=pixels.device))
    return _with_distortion(base, p)


def convert_to_forward(model: CameraModel) -> CameraModel:
    """A FORWARD model matching a single INVERSE model over a pixel grid
    (2-d pixel residuals, scaled by the focal length)."""
    if model.tag != INVERSE:
        raise ValueError("convert_to_forward takes an INVERSE model")
    pixels = _pixel_grid(model)
    rays = image_to_3d(pixels, model)
    base = model.with_tag(FORWARD)
    scale = torch.clamp_min(model.focal_length_pixels, 1.0)

    def resid(params):
        return (image_from_3d(rays, _with_distortion(base, params)) - pixels).reshape(-1) / scale

    _count_fit(FORWARD, model)
    p = _lm_fit_5param(resid, torch.zeros(5, dtype=model.dtype, device=pixels.device))
    return _with_distortion(base, p)


def _per_point(model: CameraModel) -> CameraModel:
    """Insert a point dim after a camera's batch dims, so a model with batch
    shape [...] broadcasts against points [..., N, 2]."""
    return model.replace(
        focal_length_pixels=model.focal_length_pixels[..., None],
        principal_point=model.principal_point[..., None, :],
        radial_distortion=model.radial_distortion[..., None, :],
        tangential_distortion=model.tangential_distortion[..., None, :],
    )


def distort_keypoints(points1, points2, model1: CameraModel, model2: CameraModel):
    """Correspondence undistortion: pixels [..., N, 2] -> unit rays [..., N, 3].

    model1 / model2 carry the batch shape ``...`` of the points (a single
    camera for unbatched points)."""
    return image_to_3d(points1, _per_point(model1)), image_to_3d(points2, _per_point(model2))
