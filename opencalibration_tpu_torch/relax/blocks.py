"""Residual blocks for bundle adjustment (twin of the relative-orientation
and downwards-prior families of opencalibration_tpu/relax/blocks.py).

A block family is a per-instance function ``resid_one(delta_local, data,
params)``: ``delta_local`` is the instance's slice of the tangent step,
``data`` its measurements, and the function gathers current parameters by
index. The LM solver maps it over instances with ``torch.func.vmap`` and
differentiates it with ``torch.func.jacfwd`` at delta = 0. The other six
families (pixel error, plane ray, mesh terms, points) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from opencalibration_tpu_torch.ops.quaternion import (
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
