"""The calibration step: extract -> link -> relative-orientation relax.

Twin of ``bench.py::calibration_step`` (``_model``, ``_link_all``,
``_relax_all``) and of the per-batch body of the pipeline's
INITIAL_PROCESSING state: features for every image, link work for every
candidate pair (match, undistort, RANSAC homography, pose decomposition),
then an LM relax of all camera rotations against the decomposed relative
poses and a downwards prior. Work runs on the device the input tensors lie
on; on CUDA the matching of all pairs is one launch of the Hamming top-2
kernel.
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.pipeline.stages import _match_and_ransac_batch
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.types.camera import CameraModel

MAX_FEATURES = 1024
NUM_HYPOTHESES = 2048
MAX_ITERATIONS = 50
INIT_LAMBDA = 0.1


def _model(width: int, height: int, focal: float, *, device) -> CameraModel:
    """Distortion-free pinhole with the principal point at the image centre."""
    return CameraModel.create(
        focal, (width / 2, height / 2), pixels_cols=width, pixels_rows=height,
        dtype=torch.float32, device=device,
    )


def _link_all(desc, xy, valid, pa, pb, model: CameraModel,
              num_hypotheses: int = NUM_HYPOTHESES, uniforms=None):
    """Relative poses of the pairs (pa[k], pb[k]) from extracted features
    (desc [C, N, 16], xy [C, N, 2], valid [C, N]).

    Returns (rel_quats [P, 4, 4], rel_ts [P, 4, 3], rel_scores [P, 4])."""
    pa, pb = pa.to(torch.int64), pb.to(torch.int64)
    models = model.map(lambda x: x.expand((pa.shape[0],) + x.shape))
    out = _match_and_ransac_batch(
        desc[pa], xy[pa], valid[pa], desc[pb], xy[pb], valid[pb], models, models,
        num_hypotheses=num_hypotheses, uniforms=uniforms,
    )
    return out["quats"], out["ts"], out["pose_scores"]


def _relax_all(positions, pa, pb, rel_quats, rel_ts, rel_scores,
               max_iterations: int = MAX_ITERATIONS):
    """Relax nadir-initialised camera rotations against the decomposed
    relative poses. Returns (quats [C, 4], lm.SolveInfo)."""
    dev = positions.device
    C = positions.shape[0]
    pa, pb = pa.to(torch.int64), pb.to(torch.int64)
    layout = TangentLayout(C, 0, 0, 1)
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    params = RelaxParams.create(down.tile(C, 1), positions.to(torch.float32), dtype=torch.float32)
    # keep candidates scoring at least a quarter of the pair's best
    valid4 = rel_scores > 0.25 * rel_scores[:, :1]
    blk = B.decomposed_rotation_block(
        layout, pa, pb, rel_quats, rel_ts, rel_scores, valid4,
        torch.ones(pa.shape[0], dtype=torch.float32, device=dev),
    )
    prior = B.downwards_prior_block(
        layout, torch.arange(C, device=dev), torch.ones(C, dtype=torch.float32, device=dev)
    )
    free = layout.build_free_mask(device=dev)
    solved, info = lm.solve(
        params, (blk, prior), layout, free, init_lambda=INIT_LAMBDA, max_iterations=max_iterations
    )
    return solved.quats, info


def calibration_step(images, positions, pa, pb, *, focal: float,
                     max_features: int = MAX_FEATURES, num_hypotheses: int = NUM_HYPOTHESES,
                     max_iterations: int = MAX_ITERATIONS, uniforms=None):
    """Camera rotations [C, 4] (w, x, y, z) for a survey batch.

    images [C, H, W] float in [0, 1] or uint8; positions [C, 3]; pa, pb [P]
    image indices of the candidate pairs; focal in pixels. ``uniforms``
    [num_hypotheses, 4] replaces RANSAC's seeded draw (parity tests)."""
    model = _model(images.shape[2], images.shape[1], focal, device=images.device)
    feats = F.extract_features(images, max_features=max_features)
    rel_quats, rel_ts, rel_scores = _link_all(
        feats["descriptors"], feats["xy"], feats["valid"], pa, pb, model,
        num_hypotheses, uniforms,
    )
    quats, _ = _relax_all(positions, pa, pb, rel_quats, rel_ts, rel_scores, max_iterations)
    return quats
