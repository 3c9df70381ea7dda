"""The calibration step over survey sizes on the card (twin of the
repository's bench_scale.py): one JSON line per size with the images,
pairs, seconds a step (mean of 3 after a warm-up, synchronised) and images
a second, and the card's name and power limit::

    python -m opencalibration_tpu_torch.bench.bench_scale [sizes ...]   (default: 2 10 24 48 96)
"""

from __future__ import annotations

import json
import sys
import time

import torch

from opencalibration_tpu_torch.bench import bench, bench_e2e
from opencalibration_tpu_torch.testing import survey as S

SIZES = (2, 10, 24, 48, 96)
REPEATS = 3


def run_config(n_images: int, *, device="cuda") -> dict:
    """The step on bench_e2e.py's grid of about ``n_images`` images, 12 m
    apart, each linked to its 3 nearest neighbours."""
    dev = torch.device(device)
    rows, cols = bench_e2e.survey_grid(n_images)
    positions, quats = S.camera_grid(rows, cols, spacing=bench.SPACING)
    images = S.render_views(S.make_texture(0), positions, quats, device=dev)
    pa, pb = S.knn_pairs(positions, bench.NEIGHBOURS)
    args = (images, torch.as_tensor(positions, dtype=torch.float32, device=dev),
            torch.as_tensor(pa, device=dev), torch.as_tensor(pb, device=dev))
    bench.calibration_step(*args)
    bench_e2e._sync(dev)
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        bench.calibration_step(*args)
    bench_e2e._sync(dev)
    dt = (time.perf_counter() - t0) / REPEATS
    n = rows * cols
    return dict(images=n, pairs=len(pa), seconds=round(dt, 3), images_per_sec=round(n / dt, 2),
                device=bench_e2e.device_line(dev))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for n in [int(a) for a in argv] or SIZES:
        print(json.dumps(run_config(n)), flush=True)


if __name__ == "__main__":
    main()
