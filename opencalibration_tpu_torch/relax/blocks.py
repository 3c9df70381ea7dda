"""Residual blocks for bundle adjustment (twin of
opencalibration_tpu/relax/blocks.py: the relative-orientation,
downwards-prior, pixel-error, plane-ray, mesh-prior and radial-monotonicity
families).

A block family is a per-instance function ``resid_one(delta_local, data,
params)``: ``delta_local`` is the instance's slice of the tangent step,
``data`` its measurements, and the function gathers current parameters by
index. The LM solver maps it over instances with ``torch.func.vmap`` and
differentiates it with ``torch.func.jacfwd`` at delta = 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from opencalibration_tpu_torch.ops.distort import image_from_3d, image_to_3d
from opencalibration_tpu_torch.ops.intersection import (
    corner_plane_to_norm_offset,
    ray_plane_intersection,
)
from opencalibration_tpu_torch.ops.quaternion import (
    _cross,
    _norm,
    angle_between_unit_vectors,
    quat_angle,
    quat_boxplus,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_rotate_inverse,
)
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.types.camera import FORWARD, INVERSE, CameraModel


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One batched family of residuals of identical structure."""

    slots: torch.Tensor  # [B, L] tangent slot per local delta entry
    data: dict  # tensors with leading dim B
    weight: torch.Tensor  # [B] instance weight (0 disables a padded instance)
    resid_one: Callable
    num_residuals: int
    huber_delta: float | None = None
    name: str = "block"


# ---------------------------------------------------------------------------
# Relative orientation from decomposed homographies (MultiDecomposedRotation)
# ---------------------------------------------------------------------------


def _decomposed_rotation_resid(delta, d, params: RelaxParams):
    """Residual of one edge against the best of its 4 decomposed poses."""
    q1 = quat_normalize(quat_boxplus(params.quats[d["cam_i"]], delta[0:3]))
    q2 = quat_normalize(quat_boxplus(params.quats[d["cam_j"]], delta[3:6]))
    tdiff = params.positions[d["cam_j"]] - params.positions[d["cam_i"]]
    t_norm2 = torch.sum(tdiff * tdiff)
    tdir = tdiff / torch.sqrt(torch.clamp_min(t_norm2, 1e-30))

    rel_q = quat_normalize(d["rel_quats"])  # [4, 4]
    rel_t = d["rel_ts"]  # [4, 3]
    rt_norm2 = torch.sum(rel_t * rel_t, dim=-1)  # [4]
    has_t = (t_norm2 > 1e-9) & (rt_norm2 > 1e-9)
    rel_tdir = rel_t / torch.sqrt(torch.clamp_min(rt_norm2, 1e-30))[:, None]

    r0 = angle_between_unit_vectors(quat_rotate_inverse(q1, tdir), rel_tdir)
    r1 = angle_between_unit_vectors(
        quat_rotate_inverse(q2, quat_rotate(rel_q, -tdir)), -rel_tdir
    )
    # a tensor, not a Python float: under jacfwd a scalar branch of
    # torch.where gives a float64 tangent
    pi = torch.tensor(math.pi, dtype=r0.dtype, device=r0.device)
    r0 = torch.where(has_t, r0, pi)
    r1 = torch.where(has_t, r1, pi)
    rot2_1 = quat_multiply(q1, quat_conjugate(q2))
    r2 = quat_angle(quat_multiply(rel_q, rot2_1))
    w = torch.sqrt(torch.clamp_min(d["rel_scores"], 0.0) / 8.0)
    res = w[:, None] * torch.stack([r0, r1, r2], dim=-1)  # [4, 3]
    sq = torch.sum(res * res, dim=-1)
    sq = torch.where(d["rel_valid"] & torch.isfinite(res).all(dim=-1), sq, torch.inf)
    best = torch.argmin(sq)
    res_best = torch.index_select(res, 0, best.reshape(1))[0]
    sq_best = torch.index_select(sq, 0, best.reshape(1))[0]
    # an edge with no finite valid decomposition contributes nothing
    return torch.where(torch.isfinite(sq_best), res_best, torch.zeros_like(res_best))


def decomposed_rotation_block(
    layout: TangentLayout,
    cam_i,
    cam_j,
    rel_quats,
    rel_ts,
    rel_scores,
    rel_valid,
    weight,
    huber_delta: float | None = 10.0 * math.pi / 180,
) -> BlockSpec:
    slots = torch.cat([layout.rot_slots(cam_i), layout.rot_slots(cam_j)], dim=-1)
    data = dict(
        cam_i=cam_i, cam_j=cam_j, rel_quats=rel_quats, rel_ts=rel_ts,
        rel_scores=rel_scores, rel_valid=rel_valid,
    )
    return BlockSpec(
        slots=slots, data=data, weight=weight,
        resid_one=_decomposed_rotation_resid, num_residuals=3,
        huber_delta=huber_delta, name="decomposed_rotation",
    )


# ---------------------------------------------------------------------------
# Downwards prior
# ---------------------------------------------------------------------------


def _downwards_resid(delta, d, params: RelaxParams):
    q = quat_normalize(quat_boxplus(params.quats[d["cam_i"]], delta[0:3]))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=q.dtype, device=q.device)
    ang = angle_between_unit_vectors(quat_rotate(q, up), -up)
    return (d["w"] * ang)[None]


def downwards_prior_block(layout: TangentLayout, cam_i, weight, prior_weight=1e-3):
    data = dict(cam_i=cam_i, w=torch.full(cam_i.shape, prior_weight, dtype=weight.dtype, device=weight.device))
    return BlockSpec(
        slots=layout.rot_slots(cam_i), data=data, weight=weight,
        resid_one=_downwards_resid, num_residuals=1, name="downwards_prior",
    )


# ---------------------------------------------------------------------------
# Pixel reprojection error of a 3-d point through a FORWARD model
# ---------------------------------------------------------------------------


def _pixel_error_resid(delta, d, params: RelaxParams):
    m = d["model_i"]
    q = quat_normalize(quat_boxplus(params.quats[d["cam_i"]], delta[0:3]))
    pt = params.points[d["point_i"]] + delta[3:6]
    zero = torch.zeros_like(params.focal[m])
    model = CameraModel(
        focal_length_pixels=params.focal[m] + delta[6],
        principal_point=params.principal[m] + delta[7:9],
        radial_distortion=params.radial[m] + delta[9:12],
        tangential_distortion=params.tangential[m] + delta[12:14],
        pixels_cols=zero,
        pixels_rows=zero,
        tag=FORWARD,
    )
    ray = quat_rotate_inverse(q, pt - params.positions[d["cam_i"]])
    # projected as a batch of one: on 0-d float32 coordinates jacfwd gives
    # float64 tangents
    return image_from_3d(ray[None], model)[0] - d["pixel"]


def pixel_error_block(layout: TangentLayout, cam_i, point_i, model_i, pixel, weight,
                      huber_delta: float | None = 10.0) -> BlockSpec:
    """Local tangent (L = 14): rotation, point, focal, principal point,
    radial and tangential terms. 2 residuals (pixels)."""
    slots = torch.cat(
        [
            layout.rot_slots(cam_i), layout.point_slots(point_i), layout.focal_slot(model_i),
            layout.principal_slots(model_i), layout.radial_slots(model_i), layout.tangential_slots(model_i),
        ],
        dim=-1,
    )
    data = dict(cam_i=cam_i, point_i=point_i, model_i=model_i, pixel=pixel)
    return BlockSpec(
        slots=slots, data=data, weight=weight, resid_one=_pixel_error_resid,
        num_residuals=2, huber_delta=huber_delta, name="pixel_error",
    )


# ---------------------------------------------------------------------------
# Rays against a mesh triangle (MultiRayPlaneIntersectionAngle), 5 ray slots
# ---------------------------------------------------------------------------

MAX_TRACK_RAYS = 5
ROBUST_CENTROID_ITERATIONS = 3


def robust_centroid(points, valid, huber_threshold):
    """Huber-weighted centroid of the valid rows of points [R, 3]: a fixed
    number of reweighting steps, unrolled, where reaching the reference's
    early stop freezes later updates instead of leaving the loop."""
    v = valid.to(points.dtype)
    # non-finite payloads in masked-out rows must not poison the sums
    points = torch.where(valid[:, None], points, torch.zeros_like(points))
    centroid = torch.sum(points * v[:, None], dim=0) / torch.clamp_min(torch.sum(v), 1.0)
    done = torch.zeros((), dtype=torch.bool, device=points.device)
    for _ in range(ROBUST_CENTROID_ITERATIONS):
        err = _norm(points - centroid)
        w = 1.0 / (err + 1e-8)
        w = torch.where(err > huber_threshold, w * huber_threshold / torch.clamp_min(err, 1e-30), w)
        w = w * v
        new_centroid = torch.sum(w[:, None] * points, dim=0) / torch.clamp_min(torch.sum(w), 1e-30)
        min_w = torch.amin(torch.where(valid, w, torch.full_like(w, torch.finfo(w.dtype).max)))
        max_w = torch.amax(torch.where(valid, w, torch.zeros_like(w)))
        centroid = torch.where(done, centroid, new_centroid)
        done = done | (min_w > max_w * 0.5)
    return centroid


def _make_plane_ray_resid(use_intrinsics: bool):
    """Residual of up to 5 rays against one mesh triangle: each valid ray's
    intersection with the triangle's plane, minus their robust centroid,
    over the rays' mean length. The ``fixed_dir`` form takes camera-frame
    directions as data; the ``pixel`` form undistorts pixels through the
    shared INVERSE model, whose focal, principal point and radial terms are
    in the tangent."""

    def resid(delta, d, params: RelaxParams):
        z = params.mesh_z[d["vert_idx"]] + delta[0:3]
        corners = torch.cat([d["tri_xy"], z[:, None]], dim=-1)  # [3, 3]
        norm, offset = corner_plane_to_norm_offset(corners)

        cam_idx = d["cam_idx"]  # [5]
        valid = d["ray_valid"]  # [5]
        if use_intrinsics:
            m = d["model_i"]
            zero = torch.zeros_like(params.focal[m])
            inv_model = CameraModel(
                focal_length_pixels=params.focal[m] + delta[3],
                principal_point=params.principal[m] + delta[4:6],
                radial_distortion=params.radial[m] + delta[6:9],
                tangential_distortion=params.tangential[m],
                pixels_cols=zero,
                pixels_rows=zero,
                tag=INVERSE,
            )
            dirs_cam = image_to_3d(d["pixel"], inv_model)
        else:
            dirs_cam = d["fixed_dir"]

        d_rot = delta[9:24].reshape(MAX_TRACK_RAYS, 3)
        quats = quat_normalize(quat_boxplus(params.quats[cam_idx], d_rot))
        world_dirs = quat_rotate(quats, dirs_cam)
        locs = params.positions[cam_idx]

        inter, hit = ray_plane_intersection(
            world_dirs, locs, norm.expand_as(world_dirs), offset.expand_as(locs)
        )
        inter = torch.where((valid & hit)[:, None], inter, torch.zeros_like(inter))
        v = valid.to(inter.dtype)
        n_valid = torch.clamp_min(torch.sum(v), 1.0)
        avg_dist = torch.sum(v * _norm(inter - locs)) / n_valid
        centroid = robust_centroid(inter, valid, avg_dist * 0.01)
        res = (inter - centroid) / torch.clamp_min(avg_dist, 1e-30) * v[:, None]
        # any parallel valid ray fails the whole block, as a failed cost
        # function fails the reference's solve; the LM zeroes such instances
        all_ok = torch.all(hit | ~valid)
        res = torch.where(all_ok, res, torch.full_like(res, torch.nan))
        return res.reshape(MAX_TRACK_RAYS * 3)

    return resid


_plane_ray_resid_fixed = _make_plane_ray_resid(use_intrinsics=False)
_plane_ray_resid_intrinsics = _make_plane_ray_resid(use_intrinsics=True)


def plane_ray_block(
    layout: TangentLayout,
    vert_idx,  # [B, 3] mesh vertex indices of the triangle
    tri_xy,  # [B, 3, 2] triangle xy (constant)
    cam_idx,  # [B, 5]
    ray_valid,  # [B, 5]
    weight,  # [B]
    model_i=None,  # [B] shared inverse model slot (pixel form)
    pixel=None,  # [B, 5, 2] pixels (pixel form)
    fixed_dir=None,  # [B, 5, 3] camera-frame ray directions (fixed form)
    huber_delta: float | None = 1.0 * math.pi / 180,
) -> BlockSpec:
    """Local tangent (L = 24): the 3 vertex heights, focal, principal point,
    radial terms, then 5 x 3 rotation increments. 15 residuals."""
    use_intrinsics = fixed_dir is None
    B = vert_idx.shape[0]
    if model_i is None:
        model_i = torch.zeros(B, dtype=torch.int64, device=vert_idx.device)
    slots = torch.cat(
        [
            layout.mesh_slot(vert_idx[:, 0]),
            layout.mesh_slot(vert_idx[:, 1]),
            layout.mesh_slot(vert_idx[:, 2]),
            layout.focal_slot(model_i),
            layout.principal_slots(model_i),
            layout.radial_slots(model_i),
            layout.rot_slots(cam_idx).reshape(B, MAX_TRACK_RAYS * 3),
        ],
        dim=-1,
    )
    data = dict(vert_idx=vert_idx, tri_xy=tri_xy, cam_idx=cam_idx, ray_valid=ray_valid, model_i=model_i)
    if use_intrinsics:
        data["pixel"] = pixel
        fn = _plane_ray_resid_intrinsics
    else:
        data["fixed_dir"] = fixed_dir
        fn = _plane_ray_resid_fixed
    return BlockSpec(
        slots=slots, data=data, weight=weight, resid_one=fn,
        num_residuals=MAX_TRACK_RAYS * 3, huber_delta=huber_delta, name="plane_ray",
    )


# ---------------------------------------------------------------------------
# Mesh priors: flatness between adjacent heights, an anchor to the pass-entry
# heights, and smoothness across interior edges
# ---------------------------------------------------------------------------


def _difference_resid(delta, d, params: RelaxParams):
    z1 = params.mesh_z[d["v_i"]] + delta[0]
    to_vertex = params.mesh_z[d["v_j"]] + delta[1] - d["target"]
    z2 = d["target"] + torch.where(d["target_is_vertex"], to_vertex, torch.zeros_like(to_vertex))
    return (d["w"] * (z1 - z2))[None]


def mesh_flat_block(layout: TangentLayout, v_i, v_j, weight, prior_weight=1e-4):
    """Difference of the heights of the two ends of every mesh edge."""
    dtype, dev = weight.dtype, weight.device
    data = dict(
        v_i=v_i, v_j=v_j, target=torch.zeros(v_i.shape, dtype=dtype, device=dev),
        target_is_vertex=torch.ones(v_i.shape, dtype=torch.bool, device=dev),
        w=torch.full(v_i.shape, prior_weight, dtype=dtype, device=dev),
    )
    return BlockSpec(
        slots=torch.cat([layout.mesh_slot(v_i), layout.mesh_slot(v_j)], dim=-1), data=data,
        weight=weight, resid_one=_difference_resid, num_residuals=1, name="mesh_flat",
    )


def mesh_anchor_block(layout: TangentLayout, v_i, z0, weight, prior_weight=1e-5):
    """Each mesh height against its value ``z0`` at the start of the pass."""
    dtype, dev = z0.dtype, z0.device
    data = dict(
        v_i=v_i, v_j=v_i, target=z0,
        target_is_vertex=torch.zeros(v_i.shape, dtype=torch.bool, device=dev),
        w=torch.full(v_i.shape, prior_weight, dtype=dtype, device=dev),
    )
    return BlockSpec(
        slots=torch.cat([layout.mesh_slot(v_i), layout.mesh_slot(v_i)], dim=-1), data=data,
        weight=weight, resid_one=_difference_resid, num_residuals=1, name="mesh_anchor",
    )


def _smooth_resid(delta, d, params: RelaxParams):
    """Angle between the normals of the two triangles on edge AB (C and D
    the opposite vertices). The reference's cost measures pi for coplanar
    triangles whose C and D lie on opposite sides of AB, which is how every
    interior edge is wired, so n2 is flipped by the 2-d sides of C and D and
    coplanar always measures 0. The cross products are written out:
    ``torch.linalg.cross`` fails under ``jacfwd``."""
    def corner(xy, v, k):
        return torch.cat([xy, (params.mesh_z[v] + delta[k])[None]])

    A = corner(d["xyA"], d["vA"], 0)
    B = corner(d["xyB"], d["vB"], 1)
    C = corner(d["xyC"], d["vC"], 2)
    D = corner(d["xyD"], d["vD"], 3)
    AB = B - A
    n1 = _cross(AB, C - A)
    n2 = _cross(AB, D - A)
    ab2 = d["xyB"] - d["xyA"]
    side_c = ab2[0] * (d["xyC"][1] - d["xyA"][1]) - ab2[1] * (d["xyC"][0] - d["xyA"][0])
    side_d = ab2[0] * (d["xyD"][1] - d["xyA"][1]) - ab2[1] * (d["xyD"][0] - d["xyA"][0])
    one = torch.ones_like(side_c)
    n2 = n2 * torch.where(side_c * side_d < 0, -one, one)
    n1 = n1 / torch.clamp_min(_norm(n1), 1e-30)
    n2 = n2 / torch.clamp_min(_norm(n2), 1e-30)
    return (d["w"] * angle_between_unit_vectors(n1, n2))[None]


def mesh_smooth_block(layout: TangentLayout, vA, vB, vC, vD, xyA, xyB, xyC, xyD, weight, prior_weight=1e-4):
    """Normal angle across every interior edge AB, C and D opposite it."""
    slots = torch.cat(
        [layout.mesh_slot(vA), layout.mesh_slot(vB), layout.mesh_slot(vC), layout.mesh_slot(vD)], dim=-1
    )
    data = dict(
        vA=vA, vB=vB, vC=vC, vD=vD, xyA=xyA, xyB=xyB, xyC=xyC, xyD=xyD,
        w=torch.full(vA.shape, prior_weight, dtype=xyA.dtype, device=xyA.device),
    )
    return BlockSpec(
        slots=slots, data=data, weight=weight, resid_one=_smooth_resid,
        num_residuals=1, name="mesh_smooth",
    )


# ---------------------------------------------------------------------------
# Radial monotonicity penalty
# ---------------------------------------------------------------------------

_MONOTONICITY_SAMPLES = 10


def _monotonicity_resid(delta, d, params: RelaxParams):
    """The derivative of the radial polynomial r (1 + k1 r^2 + k2 r^4 + k3 r^6)
    at 10 radii up to ``r_max``, penalised where it turns negative (the model
    would fold the image over itself there)."""
    radial = params.radial[d["model_i"]] + delta[0:3]
    i = torch.arange(1, _MONOTONICITY_SAMPLES + 1, dtype=radial.dtype, device=radial.device)
    r = d["r_max"] * i / _MONOTONICITY_SAMPLES
    r2 = r * r
    deriv = 1.0 + 3.0 * radial[0] * r2 + 5.0 * radial[1] * r2 * r2 + 7.0 * radial[2] * r2 * r2 * r2
    return torch.where(deriv < 0, -d["w"] * deriv, torch.zeros_like(deriv))


def monotonicity_block(layout: TangentLayout, model_i, r_max, obs_weight, weight):
    """One instance per camera model over its three radial slots; ``weight``
    0 switches the prior off without changing the problem's structure."""
    data = dict(model_i=model_i, r_max=r_max, w=obs_weight)
    return BlockSpec(
        slots=layout.radial_slots(model_i), data=data, weight=weight,
        resid_one=_monotonicity_resid, num_residuals=_MONOTONICITY_SAMPLES, name="monotonicity",
    )
