"""Link-stage compute of the calibration pipeline (twin of
``_match_and_ransac_one`` / ``_match_and_ransac_batch`` in
opencalibration_tpu/pipeline/stages.py).

A candidate edge is matched (Hamming + Lowe ratio), its matches undistorted
to unit rays, and a RANSAC homography fitted and decomposed into four scored
relative poses. The batch form takes a leading pair dim; on CUDA the whole
batch is matched by one launch of the Hamming top-2 kernel.
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import ransac as R
from opencalibration_tpu_torch.types.camera import CameraModel

LINK_HYPOTHESES = 2048


def _match_and_ransac_batch(
    desc1, xy1, valid1, desc2, xy2, valid2, models1: CameraModel, models2: CameraModel,
    num_hypotheses: int = LINK_HYPOTHESES, uniforms=None,
):
    """Link work of P candidate pairs at once.

    desc* [P, N, 16] int32 words, xy* [P, N, 2], valid* [P, N] bool, models*
    with batch shape [P]. Returns a dict of [P, ...] tensors: idx2, dist,
    matched, model, inliers, score, quats, ts, pose_scores."""
    idx2, dist, matched = H.match_descriptors(desc1, desc2, valid1, valid2)
    mp2 = torch.gather(xy2, 1, idx2.to(torch.int64)[..., None].expand(-1, -1, 2))
    r1, r2 = D.distort_keypoints(xy1, mp2, models1, models2)
    res, quats, ts, scores = R.ransac_homography_with_poses(
        r1, r2, dist.to(r1.dtype), matched, num_hypotheses=num_hypotheses, uniforms=uniforms
    )
    return dict(
        idx2=idx2, dist=dist, matched=matched,
        model=res.model, inliers=res.inliers, score=res.score,
        quats=quats, ts=ts, pose_scores=scores,
    )


def _match_and_ransac_one(
    desc1, xy1, valid1, desc2, xy2, valid2, model1: CameraModel, model2: CameraModel,
    num_hypotheses: int = LINK_HYPOTHESES, uniforms=None,
):
    """One candidate edge: the batch form over a batch of one."""
    out = _match_and_ransac_batch(
        desc1[None], xy1[None], valid1[None], desc2[None], xy2[None], valid2[None],
        model1.map(lambda x: x[None]), model2.map(lambda x: x[None]),
        num_hypotheses=num_hypotheses, uniforms=uniforms,
    )
    return {k: v[0] for k, v in out.items()}
