"""INITIAL_PROCESSING's overlap A/B on the card (twin of the repository's
bench_overlap_ab.py; the reference's interleave, pipeline.cpp:548-556)::

    python -m opencalibration_tpu_torch.bench.bench_overlap_ab [n_images] [legs ...] [--device cuda|cpu]
    (default: 104 warmup overlap serial overlap; --stop-after STATE; --batch-size N, default 64)

Runs ``bench_e2e.run_config`` with ``Pipeline.overlap_io`` forced on or
off: with it on, batch N decodes on host threads while batch N-2's group
relax runs on the card and batch N-1's link prepares its matches. The
overlap is a pure scheduling change (the same graph either way), so the
question is the wall time. Every leg but ``serial`` overlaps; ``warmup``
pays the first-use costs. The overlap reaches its steady state only from
the third batch on: at 104 images that takes a batch size of 51 or less. The first line is the device (the card's name and
power limit), then one JSON line per leg: ``run_config``'s keys with
``leg`` and ``overlap_io``.
"""

from __future__ import annotations

import argparse
import json

from opencalibration_tpu_torch.bench import bench_e2e
from opencalibration_tpu_torch.pipeline import pipeline as P
from opencalibration_tpu_torch.utils.device import resolve_device

LEGS = ("warmup", "overlap", "serial", "overlap")


def run_leg(n_images: int, overlap: bool, label: str, stop_after: str | None = None, *, device="cuda",
            batch_size: int = 64) -> dict:
    """One leg: ``run_config`` with every ``Pipeline`` it builds set to
    ``overlap_io = overlap``. ``Pipeline.__init__`` is wrapped for the leg
    and restored after it, also when the leg raises."""
    orig = P.Pipeline.__init__

    def patched(self, *a, **k):
        orig(self, *a, **k)
        self.overlap_io = overlap

    P.Pipeline.__init__ = patched
    try:
        rec = bench_e2e.run_config(n_images, batch_size=batch_size, stop_after=stop_after, device=device)
        rec["leg"] = label
        rec["overlap_io"] = overlap
        return rec
    finally:
        P.Pipeline.__init__ = orig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_images", nargs="?", type=int, default=104)
    ap.add_argument("legs", nargs="*")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--stop-after", default=None, help="stop each leg once this state completes")
    ap.add_argument("--batch-size", type=int, default=64, help="images a batch of INITIAL_PROCESSING")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(bench_e2e.device_line(dev), flush=True)
    for leg in args.legs or LEGS:
        rec = run_leg(args.n_images, leg != "serial", leg, args.stop_after, device=dev, batch_size=args.batch_size)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
