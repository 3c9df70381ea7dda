"""How much the essential RANSAC depends on the eigen solver's pick in the
5-point null space, on the CPU.

A 5-point essential hypothesis is the eigenvector of the smallest eigenvalue
of a rank-5 9 x 9 system: any vector of a 4-dimensional null space, which
each eigen solver (LAPACK, cuSOLVER, the JAX package's) resolves its own
way. This script runs ``ransac(..., "essential")`` on chip_smoke.py's
phase-13 scenes (2048 calibrated correspondences, 2048 hypotheses, the same
uniforms) once with ``torch.linalg.eigh``'s own pick and then with
three other picks: a seeded random unit vector of the eigenspace of
the four smallest eigenvalues wherever they vanish. It prints, per scene and
pick, the score, the inliers' precision and recall against the scene's true
correspondences and the model's distance to the true essential matrix (unit
norm, up to sign, largest entry)::

    python tools/torch_essential_bases.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as CS  # noqa: E402
from opencalibration_tpu_torch.ops import models as M  # noqa: E402
from opencalibration_tpu_torch.ops import ransac as R  # noqa: E402


PICKS = 4  # eigh's own, then three random ones


def _other_pick(gen):
    """``models._smallest_eigvec_9`` with a random vector of a vanishing
    4-dimensional eigenspace in place of the solver's own."""

    def pick(AtA):
        A, finite = M._finite_or_eye(AtA)
        w, V = torch.linalg.eigh(A)
        c = torch.randn(V.shape[:-2] + (4,), generator=gen, dtype=V.dtype)
        v = (V[..., :, :4] * (c / c.norm(dim=-1, keepdim=True))[..., None, :]).sum(-1)
        null = (w[..., 3] < 1e-12 * w[..., -1].clamp_min(1e-300))[..., None]
        return torch.where(finite[..., None], torch.where(null, v, V[..., :, 0]), torch.nan)

    return pick


def main():
    n = CS.RANSAC_N
    u = R.default_uniforms(CS.RANSAC_K, R._MODELS["essential"].min_points, R.DEFAULT_SEED, "cpu")
    scenes = [(seed, 0.15) for seed in (5, 6, 8, 9)] + [(seed, 0.0) for seed in (5, 6)]
    own = M._smallest_eigvec_9
    for seed, outliers in scenes:
        x1, x2, E, true = CS._epipolar_scene(n, seed, outliers=outliers)
        args_ = [torch.as_tensor(a) for a in (x1, x2, np.zeros(n), np.ones(n, bool))]
        for k in range(PICKS):
            M._smallest_eigvec_9 = _other_pick(torch.Generator().manual_seed(k)) if k else own
            try:
                res = R.ransac(*args_, "essential", num_hypotheses=CS.RANSAC_K, uniforms=u)
            finally:
                M._smallest_eigvec_9 = own
            inl = res.inliers.numpy()
            precision = (inl & true).sum() / max(inl.sum(), 1)
            recall = (inl & true).sum() / true.sum()
            gap = CS._sign_gap(res.model, E)
            pick = "eigh's own" if k == 0 else f"random {k}"
            print(f"scene {seed}, outliers {outliers:.2f}, pick {pick}: score {float(res.score):.4f}, "
                  f"{int(inl.sum())} inliers, precision {precision:.4f}, recall {recall:.4f}, "
                  f"model against the truth {gap:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
