"""Radiometric color-balance solve (twin of
opencalibration_tpu/ortho/color_balance.py).

Per-image Lab offsets, BRDF view-angle coefficient and directional slope,
and a per-camera-model vignetting polynomial, fitted to Lab correspondences
sampled at orthomosaic layer overlaps, with Huber(5) robustness, count-scaled
priors, and a plane-fit detrending of the offsets against camera xy (gauge
fix). Re-implements reference src/ortho/color_balance.cpp:20-227 +
radiometric_cost.hpp:21-200.

The residual model is linear in every parameter, so the solve is an
IRLS-weighted linear least squares over compact sparse rows (each touches at
most 14 columns), each inner solve a Jacobi-preconditioned CG on the normal
equations, matrix-free. The rows are assembled in numpy on the host; the
solve runs on ``device``. Its scatters are sorted segment sums in a fixed
order (``relax/lm.py``), so two runs on a GPU give the same bits, which
atomics would not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from opencalibration_tpu_torch.relax.lm import _pcg, _segment_order, _segment_sum
from opencalibration_tpu_torch.utils.device import resolve_device

HUBER_DELTA = 5.0  # reference color_balance.cpp:79
PRIOR_WEIGHT = 0.1  # count-scaled priors, color_balance.cpp:109-143
MAX_CORRESPONDENCES = 400_000


def _irls_pcg(cols, vals, rhs, T: int, n_data: int, iters: int):
    """Huber-IRLS over compact sparse rows ``cols`` [R, 14] int64, ``vals``
    [R, 14], ``rhs`` [R]; memory is O(R * 14 + T) whatever the parameter
    count T (6 per image + 3 per model). Returns (p [T], final cost)."""
    w = torch.ones(vals.shape[0], dtype=vals.dtype, device=vals.device)
    p = torch.zeros(T, dtype=vals.dtype, device=vals.device)
    # cols is fixed for the whole solve: one reduction order serves every scatter
    order = _segment_order(cols.reshape(-1), T)

    def scatter(x):  # [R, 14] -> [T]
        return _segment_sum(x.reshape(-1), order)

    def solve_once(w):
        wv = vals * w[:, None]  # weighted rows
        diag = scatter(wv * vals)
        g = scatter(wv * rhs[:, None])
        pre_d = torch.clamp(diag, 1e-12, 1e32)

        def matvec(v):
            av = torch.sum(vals * v[cols], dim=1)  # [R]
            return scatter(wv * av[:, None]) + 1e-9 * v

        x, _ = _pcg(matvec, g, lambda r: r / pre_d, rtol=1e-6, max_iters=400)
        return x

    for _ in range(iters):
        p = solve_once(w)
        r = torch.sum(vals * p[cols], dim=1) - rhs
        absr = torch.abs(r[:n_data])
        w_data = torch.where(absr <= HUBER_DELTA, 1.0, HUBER_DELTA / torch.clamp_min(absr, 1e-9))
        w = torch.cat([w_data, w[n_data:]])
    r = torch.sum(vals * p[cols], dim=1) - rhs
    return p, 0.5 * torch.sum(r * r)


@dataclasses.dataclass
class ColorCorrespondence:
    """reference ortho/color_balance.hpp ColorCorrespondence."""

    camera_id_a: int
    camera_id_b: int
    model_id_a: int
    model_id_b: int
    lab_a: np.ndarray  # [3]
    lab_b: np.ndarray
    normalized_radius_a: float
    normalized_radius_b: float
    view_angle_a: float
    view_angle_b: float
    normalized_x_a: float
    normalized_y_a: float
    normalized_x_b: float
    normalized_y_b: float


@dataclasses.dataclass
class RadiometricParams:
    lab_offset: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    brdf_coeff: float = 0.0
    slope: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))


@dataclasses.dataclass
class ColorBalanceResult:
    per_image_params: Dict[int, RadiometricParams] = dataclasses.field(default_factory=dict)
    per_model_vignetting: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    success: bool = False
    final_cost: float = 0.0


def _l_correction(params_row, vig, r, theta, nx, ny):
    """L-channel correction terms given a camera's 6-param row + vig[3]."""
    r2 = r * r
    return (
        vig[0] * r2 + vig[1] * r2**2 + vig[2] * r2**3
        + params_row[3] * theta * theta
        + params_row[4] * nx + params_row[5] * ny
    )


def solve_color_balance(
    correspondences,
    camera_positions: Optional[Dict[int, np.ndarray]] = None,
    irls_iterations: int = 5,
    *,
    device="cuda",
) -> ColorBalanceResult:
    """Fit the radiometric parameters to ``correspondences`` in float32 on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    result = ColorBalanceResult()
    if not correspondences:
        return result

    cam_ids = sorted(
        {c.camera_id_a for c in correspondences} | {c.camera_id_b for c in correspondences}
    )
    model_ids = sorted(
        {c.model_id_a for c in correspondences} | {c.model_id_b for c in correspondences}
    )
    cam_slot = {cid: i for i, cid in enumerate(cam_ids)}
    model_slot = {mid: i for i, mid in enumerate(model_ids)}
    NC, NM = len(cam_ids), len(model_ids)
    # layout: per camera [L_off, a_off, b_off, brdf, slope_x, slope_y] then
    # per model [vig1, vig2, vig3]
    T = 6 * NC + 3 * NM

    # Deterministic subsample cap: the IRLS fit is statistical, and beyond a
    # few hundred thousand samples extra rows only add wall time
    if len(correspondences) > MAX_CORRESPONDENCES:
        step = -(-len(correspondences) // MAX_CORRESPONDENCES)
        correspondences = correspondences[::step]
    n = len(correspondences)

    # ---- compact sparse rows: each correspondence contributes 3 residual
    # rows touching <= 14 columns, so assembly is O(n * 14) and the solve
    # matrix-free (a dense [rows, T] design matrix would be O(n * T))
    ia = np.fromiter((cam_slot[c.camera_id_a] for c in correspondences), np.int64, n)
    ib = np.fromiter((cam_slot[c.camera_id_b] for c in correspondences), np.int64, n)
    ma = np.fromiter((model_slot[c.model_id_a] for c in correspondences), np.int64, n)
    mb = np.fromiter((model_slot[c.model_id_b] for c in correspondences), np.int64, n)
    ra = np.fromiter((c.normalized_radius_a for c in correspondences), np.float64, n)
    rb = np.fromiter((c.normalized_radius_b for c in correspondences), np.float64, n)
    va = np.fromiter((c.view_angle_a for c in correspondences), np.float64, n)
    vb = np.fromiter((c.view_angle_b for c in correspondences), np.float64, n)
    nxa = np.fromiter((c.normalized_x_a for c in correspondences), np.float64, n)
    nya = np.fromiter((c.normalized_y_a for c in correspondences), np.float64, n)
    nxb = np.fromiter((c.normalized_x_b for c in correspondences), np.float64, n)
    nyb = np.fromiter((c.normalized_y_b for c in correspondences), np.float64, n)
    lab_a = np.stack([np.asarray(c.lab_a, np.float64) for c in correspondences])
    lab_b = np.stack([np.asarray(c.lab_b, np.float64) for c in correspondences])

    cam_count = np.bincount(ia, minlength=NC) + np.bincount(ib, minlength=NC)
    model_count = np.bincount(ma, minlength=NM) + np.bincount(mb, minlength=NM)

    W = 14
    VC = 6 * NC
    r2a, r2b = ra * ra, rb * rb
    one = np.ones(n)
    # L channel: offsets + brdf + slope + vignetting
    cols0 = np.stack(
        [
            6 * ia, 6 * ib, 6 * ia + 3, 6 * ib + 3, 6 * ia + 4, 6 * ia + 5,
            6 * ib + 4, 6 * ib + 5,
            VC + 3 * ma, VC + 3 * ma + 1, VC + 3 * ma + 2,
            VC + 3 * mb, VC + 3 * mb + 1, VC + 3 * mb + 2,
        ],
        axis=1,
    )
    vals0 = np.stack(
        [
            -one, one, -va * va, vb * vb, -nxa, -nya, nxb, nyb,
            -r2a, -(r2a**2), -(r2a**3), r2b, r2b**2, r2b**3,
        ],
        axis=1,
    )
    # a / b channels: offsets only
    def _offset_rows(ch):
        cols = np.zeros((n, W), np.int64)
        vals = np.zeros((n, W))
        cols[:, 0] = 6 * ia + ch
        cols[:, 1] = 6 * ib + ch
        vals[:, 0] = -1.0
        vals[:, 1] = 1.0
        return cols, vals

    cols1, vals1 = _offset_rows(1)
    cols2, vals2 = _offset_rows(2)
    # residual = (obs_a - corr_a) - (obs_b - corr_b)
    rhs_data = np.concatenate(
        [lab_b[:, 0] - lab_a[:, 0], lab_b[:, 1] - lab_a[:, 1], lab_b[:, 2] - lab_a[:, 2]]
    )
    cols_data = np.concatenate([cols0, cols1, cols2])
    vals_data = np.concatenate([vals0, vals1, vals2])
    n_data = 3 * n

    # count-scaled priors pulling every parameter to 0 (one nonzero each)
    s_cam = PRIOR_WEIGHT * np.sqrt(np.maximum(1.0, cam_count))
    s_mod = PRIOR_WEIGHT * np.sqrt(np.maximum(1.0, model_count))
    prior_col = np.concatenate(
        [
            (6 * np.arange(NC)[:, None] + np.arange(6)[None]).reshape(-1),
            (VC + 3 * np.arange(NM)[:, None] + np.arange(3)[None]).reshape(-1),
        ]
    )
    prior_val = np.concatenate(
        [np.repeat(s_cam, 6), np.repeat(s_mod, 3)]
    )
    n_prior = len(prior_col)
    cols_p = np.zeros((n_prior, W), np.int64)
    vals_p = np.zeros((n_prior, W))
    cols_p[:, 0] = prior_col
    vals_p[:, 0] = prior_val

    cols = np.concatenate([cols_data, cols_p])
    vals = np.concatenate([vals_data, vals_p]).astype(np.float32)
    rhs = np.concatenate([rhs_data, np.zeros(n_prior)]).astype(np.float32)

    p, final_cost = _irls_pcg(
        torch.from_numpy(cols).to(device), torch.from_numpy(vals).to(device),
        torch.from_numpy(rhs).to(device), T=T, n_data=n_data, iters=irls_iterations,
    )
    p = p.cpu().numpy().astype(np.float64)
    result.final_cost = float(final_cost)
    result.success = True

    for cid, i in cam_slot.items():
        result.per_image_params[cid] = RadiometricParams(
            lab_offset=p[6 * i : 6 * i + 3].copy(),
            brdf_coeff=float(p[6 * i + 3]),
            slope=p[6 * i + 4 : 6 * i + 6].copy(),
        )
    for mid, m in model_slot.items():
        result.per_model_vignetting[mid] = p[6 * NC + 3 * m : 6 * NC + 3 * m + 3].copy()

    # gauge fix: SVD plane-fit detrend of offsets vs camera xy
    # (reference color_balance.cpp:163-216)
    if camera_positions:
        order = [cid for cid in cam_ids if cid in camera_positions]
        if len(order) >= 3:
            Axy = np.stack(
                [
                    [camera_positions[cid][0], camera_positions[cid][1], 1.0]
                    for cid in order
                ]
            )
            for ch in range(3):
                bvec = np.asarray(
                    [result.per_image_params[cid].lab_offset[ch] for cid in order]
                )
                plane, *_ = np.linalg.lstsq(Axy, bvec, rcond=None)
                for cid in order:
                    fitted = (
                        plane[0] * camera_positions[cid][0]
                        + plane[1] * camera_positions[cid][1]
                        + plane[2]
                    )
                    result.per_image_params[cid].lab_offset[ch] -= fitted
    return result


def apply_correction(lab, params: RadiometricParams, vig, r, theta, nx, ny):
    """Apply a solved correction to Lab samples (the blend pass's
    per-sample correction, reference ortho.cpp:1839-1875)."""
    lab = np.asarray(lab, np.float64).copy()
    lab -= params.lab_offset
    r2 = r * r
    lab[..., 0] -= (
        vig[0] * r2 + vig[1] * r2**2 + vig[2] * r2**3
        + params.brdf_coeff * theta * theta
        + params.slope[0] * nx + params.slope[1] * ny
    )
    return lab
