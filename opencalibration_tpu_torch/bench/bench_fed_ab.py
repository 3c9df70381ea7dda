"""FED (AKAZE nonlinear diffusion) against the Gaussian scale space on the
card (twin of the repository's bench_fed_ab.py)::

    python -m opencalibration_tpu_torch.bench.bench_fed_ab [modes ...] [--device cuda|cpu]   (default: gaussian fed)

The reference's detector is AKAZE's nonlinear diffusion; the port, as the
JAX package, defaults to a decimated Gaussian octave pyramid with ``fed``
opt-in (``ops/features.py``). On the bench workload (``bench.py``'s 24
images, 42 pairs), for each diffusion mode:

* the extraction's time (the second of two calls, synchronised), 1024
  keypoints an image;
* repeatability under the survey's real viewpoint changes: the share of the
  keypoints of image A whose true reprojection into neighbour B lands within
  3 px of a keypoint detected in B;
* the matching yield: the best pose score of each pair through the link's
  Hamming + ratio + RANSAC path (``pipeline/calibration.py::_link_all``);
* the median tilt of the relaxed optical axes from nadir after the
  relative-orientation relax (``_relax_all``).

The first line is the device (the card's name and power limit), then one
JSON line per mode with the original's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from opencalibration_tpu_torch.bench import bench_e2e
from opencalibration_tpu_torch.bench.bench import N_IMAGES, ROWS, SPACING, build_workload
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops.quaternion import quat_rotate, quat_rotate_inverse
from opencalibration_tpu_torch.pipeline import calibration as C
from opencalibration_tpu_torch.testing.survey import FOCAL, IMG_H, IMG_W, camera_grid
from opencalibration_tpu_torch.utils.device import resolve_device

MODES = ("gaussian", "fed")
MAX_FEATURES = 1024


def _extract(images, diffusion):
    return F.extract_features(images.to(torch.float32), max_features=MAX_FEATURES, diffusion=diffusion)


def _reproject(xy, pos_a, quat_a, pos_b, quat_b):
    """Ground-truth reprojection through the survey's exact poses (nadir
    + random yaw, two flight levels): pixel -> ray -> z=0 ground point
    under camera a -> projected pixel under camera b. numpy in, numpy out."""
    d_cam = np.stack(
        [
            (xy[..., 0] - IMG_W / 2) / FOCAL,
            (xy[..., 1] - IMG_H / 2) / FOCAL,
            np.ones_like(xy[..., 0]),
        ],
        axis=-1,
    )
    qa = torch.as_tensor(quat_a).broadcast_to(d_cam.shape[:-1] + (4,))
    d_world = quat_rotate(qa, torch.as_tensor(d_cam)).numpy()
    t = -pos_a[2] / np.where(np.abs(d_world[..., 2]) < 1e-9, 1e-9, d_world[..., 2])
    g = pos_a + t[..., None] * d_world
    rel = g - pos_b
    qb = torch.as_tensor(quat_b).broadcast_to(rel.shape[:-1] + (4,))
    v_cam = quat_rotate_inverse(qb, torch.as_tensor(rel)).numpy()
    z = np.where(np.abs(v_cam[..., 2]) < 1e-9, 1e-9, v_cam[..., 2])
    u = FOCAL * v_cam[..., 0] / z + IMG_W / 2
    v = FOCAL * v_cam[..., 1] / z + IMG_H / 2
    return np.stack([u, v], axis=-1)


def run_mode(diffusion, images, positions, quats_gt, pa, pb, *, device="cuda"):
    """One mode's line on the workload (images [N, H, W] float32, numpy
    positions, true quaternions and pair indices)."""
    dev = torch.device(device)
    imgs = torch.as_tensor(images, device=dev)
    print(f"[{diffusion}] first extraction...", file=sys.stderr, flush=True)
    feats = _extract(imgs, diffusion)
    bench_e2e._sync(dev)
    t0 = time.perf_counter()
    feats = _extract(imgs, diffusion)
    bench_e2e._sync(dev)
    extract_s = time.perf_counter() - t0

    xy = feats["xy"].cpu().numpy()
    valid = feats["valid"].cpu().numpy()

    # repeatability: nadir ground-truth reprojection into each neighbour
    rep_hits, rep_total = 0, 0
    for a, b in zip(np.asarray(pa), np.asarray(pb)):
        pr = _reproject(xy[a], positions[a], quats_gt[a], positions[b], quats_gt[b])
        inb = (
            valid[a]
            & (pr[:, 0] >= 0) & (pr[:, 0] < IMG_W)
            & (pr[:, 1] >= 0) & (pr[:, 1] < IMG_H)
        )
        if not inb.any():
            continue
        d = np.linalg.norm(pr[inb][:, None, :] - xy[b][None, valid[b]], axis=-1)
        rep_hits += int((d.min(axis=1) < 3.0).sum())
        rep_total += int(inb.sum())

    print(f"[{diffusion}] repeatability done, linking...", file=sys.stderr, flush=True)
    # the link's match + RANSAC path -> pose decomposition scores
    pa_t, pb_t = torch.as_tensor(pa, device=dev), torch.as_tensor(pb, device=dev)
    model = C._model(IMG_W, IMG_H, FOCAL, device=dev)
    rel_quats, rel_ts, rel_scores = C._link_all(feats["descriptors"], feats["xy"], feats["valid"], pa_t, pb_t, model)
    quats, _ = C._relax_all(torch.as_tensor(positions, dtype=torch.float32, device=dev), pa_t, pb_t,
                            rel_quats, rel_ts, rel_scores)
    # pose error: every true orientation is nadir with a small yaw;
    # compare the relaxed optical axes to straight down
    axes = quat_rotate(quats, torch.tensor([0.0, 0.0, 1.0], dtype=quats.dtype, device=dev)).cpu().numpy()
    tilt_deg = np.degrees(np.arccos(np.clip(-axes[:, 2], -1, 1)))
    scores = rel_scores.cpu().numpy()
    return dict(
        diffusion=diffusion,
        extract_s=extract_s,
        images_per_sec_extract=N_IMAGES / extract_s,
        repeatability_3px=rep_hits / max(rep_total, 1),
        mean_best_pose_score=float(scores.max(axis=1).mean()),
        pairs_with_pose=int((scores.max(axis=1) > 0).sum()),
        n_pairs=int(len(np.asarray(pa))),
        median_tilt_err_deg=float(np.median(tilt_deg)),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(bench_e2e.device_line(dev), flush=True)
    images, positions, pa, pb = build_workload(device=dev)
    # the grid build_workload renders (bench.py: ROWS x cols)
    _, quats_gt = camera_grid(ROWS, N_IMAGES // ROWS, spacing=SPACING)
    for diffusion in args.modes or MODES:
        print(json.dumps(run_mode(diffusion, images, positions, quats_gt, pa, pb, device=dev)), flush=True)


if __name__ == "__main__":
    main()
