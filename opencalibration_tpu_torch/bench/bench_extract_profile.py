"""Stage-level profile of the port's ``extract_features`` on the card (twin
of the repository's bench_extract_profile.py)::

    python -m opencalibration_tpu_torch.bench.bench_extract_profile [batch] [--device cuda|cpu]   (batch: 8)

Times, on a batch of random 1200 x 1600 images: ``extract_features``, then
``detect``, ``describe`` on fixed detections, the octave pyramid's blurs
alone, the octave-0 Hessian over 4 full-resolution levels, and NMS + top-k +
subpixel refinement at octave 0, each the mean of 5 calls after a warm-up
call, the device synchronised before every clock reading. Every stage runs
in full float32, as ``extract_features`` runs it. The first line is the
device (the card's name and power limit); the table is the original's. The
images are uploaded in one piece (as uint8, scaled on the device, as the
pipeline ships them).
"""

from __future__ import annotations

import argparse
import functools
import math

import numpy as np
import torch

from opencalibration_tpu_torch.bench import bench_e2e, bench_kernels
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.utils.device import full_fp32, resolve_device

H, W = 1200, 1600
MAX_FEATURES = 2048
REPEATS = 5


timeit = functools.partial(bench_kernels.timeit, repeats=REPEATS)


def pyramid_only(images):
    """The octave pyramid's blurs (sublevels from each other, as the
    original's profile builds them), no Hessian or NMS."""
    base = F._blur(images, F.BASE_SIGMA)
    outs = []
    for _ in range(F.NUM_OCTAVES):
        cur = base
        cur_rel = F.BASE_SIGMA
        for s in range(F.SUBLEVELS):
            rel = F.BASE_SIGMA * (2.0 ** (s / F.SUBLEVELS))
            if rel > cur_rel:
                cur = F._blur(cur, math.sqrt(rel * rel - cur_rel**2))
                cur_rel = rel
        outs.append(cur.sum())
        nxt = F._blur(cur, math.sqrt((2 * F.BASE_SIGMA) ** 2 - cur_rel**2))
        base = nxt[:, ::2, ::2]
    return torch.stack(outs)


def profile(B=8, *, device, height=H, width=W):
    """Seconds a call of each stage on a [B, height, width] batch:
    [(name, seconds)] in the original's order."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    host = (rng.random((B, height, width)) * 255).astype(np.uint8)
    print("uploading", flush=True)
    imgs = torch.as_tensor(host, device=dev).to(torch.float32) / 255.0
    bench_e2e._sync(dev)
    print("uploaded", flush=True)

    with full_fp32():
        t_full = timeit(lambda x: F.extract_features(x, max_features=MAX_FEATURES), imgs, device=dev)
        print("full done", t_full, flush=True)
        t_detect = timeit(lambda x: F.detect(x, max_features=MAX_FEATURES), imgs, device=dev)
        print("detect done", t_detect, flush=True)

        det = F.detect(imgs, max_features=MAX_FEATURES)
        t_describe = timeit(F.describe, imgs, det, device=dev)
        t_pyr = timeit(pyramid_only, imgs, device=dev)

        # hessian responses on one full-res 4-level stack (octave-0 cost)
        L0 = torch.stack([imgs] * F.SUBLEVELS)
        sig = torch.tensor([1.6, 1.9, 2.26, 2.69], dtype=torch.float32, device=dev)
        t_hess = timeit(F.hessian_response, L0, sig, device=dev)

        # NMS + topk + subpixel on octave-0-sized responses
        Rb = F.hessian_response(L0, sig).transpose(0, 1).contiguous()
        t_cand = timeit(lambda r: F._candidates_from_levels(r, 1e-4, 16, MAX_FEATURES, 1.0), Rb, device=dev)
    return [
        ("extract_features (fused)", t_full),
        ("detect", t_detect),
        ("describe", t_describe),
        ("pyramid blurs only", t_pyr),
        ("hessian octave-0 (4 levels, full res)", t_hess),
        ("NMS+topk+subpixel octave-0", t_cand),
    ]


def table(rows, B, *, device, height=H, width=W):
    """The original's table of ``profile``'s rows."""
    print(f"batch={B} {height}x{width} on {torch.device(device).type}")
    for name, t in rows:
        print(f"{name:42s} {t * 1e3:8.1f} ms  {B / t:7.1f} img/s", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(bench_e2e.device_line(dev), flush=True)
    table(profile(args.batch, device=dev), args.batch, device=dev)


if __name__ == "__main__":
    main()
