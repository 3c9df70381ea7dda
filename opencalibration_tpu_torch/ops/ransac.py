"""Batched-hypothesis RANSAC for homographies, essential and fundamental
matrices (twin of opencalibration_tpu/ops/ransac.py).

K hypotheses are sampled with the PROSAC pool schedule, fitted and scored
(MSAC, 1 - (e/t)^2) all at once, the best is refitted five times on its
inliers with accept-if-better, and the result is decomposed into four scored
relative poses. A fundamental matrix whose inliers lie mostly on one plane
is tested against F = [e']_x H (DEGENSAC). Every function takes optional
leading dims, so a batch of pairs runs as one call. Padded correspondences
carry valid=False and never contribute.

Randomness: the [K, S] uniforms that pick the samples are an optional input.
By default they come from a CPU ``torch.Generator`` seeded with ``seed`` in
float64 and are moved to the data's device, so the CPU and CUDA runs of the
port draw the same samples. Parity tests pass the reference's own
``jax.random`` uniforms instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from opencalibration_tpu_torch.ops import models as M
from opencalibration_tpu_torch.ops.quaternion import _cross
from opencalibration_tpu_torch.utils.device import full_fp32

DEFAULT_SEED = 42
MAX_INNER_ITERATIONS = 5
DEFAULT_HYPOTHESES = 4096
_POOL_GROWTH_PERIOD = 4  # grow the quality pool by 1 every 4 hypotheses


class RansacResult(NamedTuple):
    model: torch.Tensor  # [..., 3, 3]
    inliers: torch.Tensor  # [..., N] bool
    score: torch.Tensor  # [...] best MSAC score / number of valid entries


class _ModelDef(NamedTuple):
    min_points: int
    threshold: float
    fit: Callable
    fit_weighted: Callable
    error: Callable
    sample_degenerate: Optional[Callable]


_MODELS = {
    "homography": _ModelDef(M.HOMOGRAPHY_MIN_POINTS, M.HOMOGRAPHY_INLIER_THRESHOLD, M.homography_fit,
                            M.homography_fit_weighted, M.homography_error, M.homography_sample_degenerate),
    "essential": _ModelDef(M.ESSENTIAL_MIN_POINTS, M.ESSENTIAL_INLIER_THRESHOLD, M.essential_fit,
                           M.essential_fit_weighted, M.epipolar_error, None),
    "fundamental": _ModelDef(M.FUNDAMENTAL_MIN_POINTS, M.FUNDAMENTAL_INLIER_THRESHOLD, M.fundamental_fit,
                             M.fundamental_fit_weighted, M.epipolar_error, None),
}


def default_uniforms(num_hypotheses: int, min_points: int, seed: int, device) -> torch.Tensor:
    """[K, S] float64 uniforms in [0, 1) from a seeded CPU generator."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = torch.rand((num_hypotheses, min_points), generator=gen, dtype=torch.float64)
    return u.to(device)


def _msac_score(err, threshold, valid):
    """MSAC per-correspondence score 1 - (e/t)^2 for inliers, else 0."""
    ratio = err / threshold
    inlier = (err < threshold) & valid
    return torch.where(inlier, 1.0 - ratio * ratio, 0.0), inlier


def _sample_hypotheses(uniforms, quality, valid, n_hyp, min_points, has_quality):
    """[..., n_hyp, min_points] correspondence indices.

    Correspondences are ranked by quality ascending (lower is better);
    hypothesis k draws without replacement from the best pool(k), a pool
    growing by one every _POOL_GROWTH_PERIOD hypotheses (uniform over all
    valid entries without quality). Each draw picks a rank in [0, pool - i)
    and is bumped past every smaller rank drawn before it. ``uniforms`` is
    [n_hyp, min_points] and is used at its own precision: truncating
    u * m after rounding u to float32 would pick other ranks."""
    n_valid = valid.sum(dim=-1)  # [...]
    # invalid entries sort last, so ranks below pool <= n_valid are valid
    order = torch.argsort(torch.where(valid, quality, torch.inf), dim=-1, stable=True)
    k_idx = torch.arange(n_hyp, device=quality.device)
    nv = n_valid[..., None]
    pool = torch.minimum(min_points + k_idx // _POOL_GROWTH_PERIOD, nv)
    pool = torch.maximum(pool, torch.clamp_max(nv, min_points))
    pool = torch.where(has_quality[..., None], pool, nv)  # [..., K]

    picks = []
    for i in range(min_points):
        m = torch.clamp_min(pool - i, 1)
        d = torch.minimum((uniforms[:, i] * m).to(torch.int64), m - 1)
        if picks:
            prev = torch.sort(torch.stack(picks, dim=-1), dim=-1).values
            for j in range(prev.shape[-1]):
                d = d + (d >= prev[..., j]).to(torch.int64)
        picks.append(d)
    # n_valid < min_points duplicates ranks; the feasibility gate voids it
    ranks = torch.stack(picks, dim=-1)  # [..., K, S]
    flat = torch.gather(order, -1, ranks.reshape(ranks.shape[:-2] + (-1,)))
    return flat.reshape(ranks.shape)


def _gather_points(p, idx):
    """p [..., N, 2], idx [..., K, S] -> [..., K, S, 2]."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    g = torch.gather(p, -2, flat[..., None].expand(flat.shape + (p.shape[-1],)))
    return g.reshape(idx.shape + (p.shape[-1],))


def _fundamental_degensac(F, score, inliers, p1, p2, valid, threshold):
    """Plane-degeneracy recovery: a homography through the first 4
    F-inliers (twice the threshold); when at least 70 % of the F-inliers are
    its inliers, the epipole from the off-plane points gives the candidate
    F = [e']_x H, kept where it scores better. Leading dims are pairs.
    Returns (F, score, inliers, used)."""
    dtype = p1.dtype
    h_threshold = 2.0 * threshold
    n_inl = inliers.sum(dim=-1)
    # the first 4 inliers in index order
    h_idx = torch.argsort((~inliers).to(torch.int8), dim=-1, stable=True)[..., :4]
    take = lambda p: torch.gather(p, -2, h_idx[..., None].expand(h_idx.shape + (2,)))  # noqa: E731
    H = M.homography_fit(take(p1), take(p2))
    h_inl = inliers & (M.homography_error(H, p1, p2) < h_threshold)
    h_ratio = h_inl.sum(dim=-1) / torch.clamp_min(n_inl, 1)
    # refit H on its inliers, classify again
    H2 = M.homography_fit_weighted(p1, p2, h_inl.to(dtype))
    off_plane = inliers & ~(inliers & (M.homography_error(H2, p1, p2) < h_threshold))
    n_off = off_plane.sum(dim=-1)

    # the epipole: rows x2 x (H x1) of the off-plane points, smallest
    # eigenvector of their normal matrix
    o = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, o], dim=-1)
    x2 = torch.cat([p2, o], dim=-1)
    Hx1 = x1 @ H2.transpose(-1, -2)
    rows = _cross(x2, Hx1) * off_plane[..., None].to(dtype)
    AtA, finite = M._finite_or_eye(rows.transpose(-1, -2) @ rows)
    e = torch.linalg.eigh(AtA)[1][..., :, 0]
    e = torch.where(finite[..., None], e, torch.nan)
    z = torch.zeros_like(e[..., 0])
    e_cross = torch.stack([
        torch.stack([z, -e[..., 2], e[..., 1]], dim=-1),
        torch.stack([e[..., 2], z, -e[..., 0]], dim=-1),
        torch.stack([-e[..., 1], e[..., 0], z], dim=-1),
    ], dim=-2)
    Uf, df, Vft = M._svd3(e_cross @ H2)
    F_cand = (Uf * torch.cat([df[..., :2], torch.zeros_like(df[..., 2:])], dim=-1)[..., None, :]) @ Vft

    cand_per, cand_inl = _msac_score(M.epipolar_error(F_cand, p1, p2), threshold, valid)
    cand_score = cand_per.sum(dim=-1)
    use = ((n_inl >= 4) & (h_ratio >= 0.7) & (n_off >= 2) & torch.isfinite(cand_score) & (cand_score > score)
           & torch.isfinite(F_cand).all(dim=-1).all(dim=-1))
    return (torch.where(use[..., None, None], F_cand, F), torch.where(use, cand_score, score),
            torch.where(use[..., None], cand_inl, inliers), use)


def ransac(
    rays1,
    rays2,
    quality,
    valid,
    model_type: str = "homography",
    num_hypotheses: int = DEFAULT_HYPOTHESES,
    seed: int = DEFAULT_SEED,
    uniforms=None,
) -> RansacResult:
    """Robust two-view model fit over padded correspondences.

    rays1, rays2 [..., N, 3] unit rays; quality [..., N], lower is better,
    all-zero disables PROSAC; valid [..., N] bool; ``model_type``
    "homography", "essential" or "fundamental". ``uniforms`` [K, S] (S the
    model's minimal sample: 4, 5 or 8) replaces the seeded draw (see the
    module docstring)."""
    if model_type not in _MODELS:
        raise ValueError(f"unknown model_type {model_type!r}")
    mdef = _MODELS[model_type]
    min_points, threshold = mdef.min_points, mdef.threshold
    dtype, dev = rays1.dtype, rays1.device
    batch, n = rays1.shape[:-2], rays1.shape[-2]
    if n < min_points:
        return RansacResult(
            torch.full(batch + (3, 3), torch.nan, dtype=dtype, device=dev),
            torch.zeros(batch + (n,), dtype=torch.bool, device=dev),
            torch.zeros(batch, dtype=dtype, device=dev),
        )
    if uniforms is None:
        uniforms = default_uniforms(num_hypotheses, min_points, seed, dev)
    if tuple(uniforms.shape) != (num_hypotheses, min_points):
        raise ValueError(f"uniforms must be [{num_hypotheses}, {min_points}]")

    with full_fp32():
        p1 = M.hnormalize(rays1)
        p2 = M.hnormalize(rays2)
        has_quality = torch.any(quality != 0, dim=-1)
        samples = _sample_hypotheses(
            uniforms.to(dev), quality, valid, num_hypotheses, min_points, has_quality
        )
        sp1 = _gather_points(p1, samples)  # [..., K, S, 2]
        sp2 = _gather_points(p2, samples)

        hyps = mdef.fit(sp1, sp2)  # [..., K, 3, 3]
        if mdef.sample_degenerate is not None:
            degenerate = mdef.sample_degenerate(sp1)
        else:
            degenerate = torch.zeros(hyps.shape[:-2], dtype=torch.bool, device=dev)
        n_valid = valid.sum(dim=-1)
        feasible = n_valid >= min_points

        errs = mdef.error(hyps, p1[..., None, :, :], p2[..., None, :, :])  # [..., K, N]
        scores_per, _ = _msac_score(errs, threshold, valid[..., None, :])
        scores = scores_per.sum(dim=-1)
        bad = degenerate | ~torch.isfinite(hyps).all(dim=-1).all(dim=-1)
        scores = torch.where(bad, -1.0, scores)

        best_k = torch.argmax(scores, dim=-1)  # first maximum
        model = torch.gather(hyps, -3, best_k[..., None, None, None].expand(batch + (1, 3, 3)))[..., 0, :, :]
        score = torch.gather(scores, -1, best_k[..., None])[..., 0]
        _, inliers = _msac_score(mdef.error(model, p1, p2), threshold, valid)

        # iterative refit on inliers, accept-if-better
        for _ in range(MAX_INNER_ITERATIONS):
            cand = mdef.fit_weighted(p1, p2, inliers.to(dtype))
            cand_per, cand_inl = _msac_score(mdef.error(cand, p1, p2), threshold, valid)
            cand_score = cand_per.sum(dim=-1)
            better = (
                torch.isfinite(cand_score) & (cand_score > score)
                & torch.isfinite(cand).all(dim=-1).all(dim=-1)
            )
            model = torch.where(better[..., None, None], cand, model)
            score = torch.where(better, cand_score, score)
            inliers = torch.where(better[..., None], cand_inl, inliers)

        if model_type == "fundamental":
            model, score, inliers, _ = _fundamental_degensac(model, score, inliers, p1, p2, valid, threshold)

        ok = feasible & (score > 0)
        final_model = torch.where(ok[..., None, None], model, torch.nan)
        final_inliers = inliers & ok[..., None]
        denom = torch.clamp_min(n_valid.to(dtype), 1.0)
        final_score = torch.where(ok, score, 0.0) / denom
    return RansacResult(final_model, final_inliers, final_score)


def ransac_homography_with_poses(
    rays1, rays2, quality, valid, num_hypotheses: int = DEFAULT_HYPOTHESES,
    seed: int = DEFAULT_SEED, uniforms=None,
):
    """RANSAC homography + pose decomposition, the link compute of one or a
    batch of pairs. Returns (result, quats [..., 4, 4], t_src [..., 4, 3],
    pose scores [..., 4]), candidates sorted by descending score (stable).

    t_src is the translation direction in the source camera's frame:
    -R_H^T t_H, where the decomposition gives t_H in the destination frame."""
    res = ransac(rays1, rays2, quality, valid, "homography", num_hypotheses, seed, uniforms)
    with full_fp32():
        R, t, nrm, _ = M.homography_decompose(res.model)
        scores = M.score_homography_poses(R, t, nrm, rays1, rays2, res.inliers.to(rays1.dtype))
        order = torch.argsort(-scores, dim=-1, stable=True)
        R = torch.gather(R, -3, order[..., None, None].expand(order.shape + (3, 3)))
        t = torch.gather(t, -2, order[..., None].expand(order.shape + (3,)))
        quats = M.poses_to_quaternions(R)
        t_src = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return res, quats, t_src, torch.gather(scores, -1, order)
