"""Why the lane-batched LM pins cuSOLVER on the card
(``utils/device.py::lane_invariant_linalg``), and that the independent-lane
solve on several shards of one card then equals the one-device solve bit
for bit.

Builds the dry run's tiny ground-mesh groups (``parallel/dryrun.py``) as one
unshared float64 batch of ``--groups`` lanes on the card. First the LM of
``lm.solve_batch`` without the pin, under each of PyTorch's linear-algebra
backends (``torch.backends.cuda.preferred_linalg_library``: the default,
which picks the factorisation by the batch size, and cuSOLVER for every
batch): all lanes in one call against the lanes cut into ``--shards`` calls.
Then ``solve_group_batch`` as the pipeline calls it, on one device and on
``--shards`` shards of the card. Per leaf it prints the largest absolute
difference and the leaf's largest magnitude. Needs a CUDA device::

    python tools/torch_shard_bits.py --groups 4 --shards 2
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencalibration_tpu_torch.parallel import dryrun  # noqa: E402
from opencalibration_tpu_torch.parallel import group_solver as GS  # noqa: E402
from opencalibration_tpu_torch.relax import lm  # noqa: E402
from opencalibration_tpu_torch.relax.tangent import FIELDS  # noqa: E402
from opencalibration_tpu_torch.utils.device import full_fp32  # noqa: E402


def _leaf_gaps(a, b):
    return {f: (float((getattr(a, f) - getattr(b, f)).abs().max()), float(getattr(b, f).abs().max()))
            for f in FIELDS if getattr(b, f).numel()}


def main(argv=()):
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=20)
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    batch = GS.build_group_batch([dryrun.make_tiny_built_problem(g, dtype=torch.float64, device="cuda")
                                  for g in range(args.groups)])
    layout, G = batch.layout, args.groups
    lam0 = torch.ones(G, dtype=torch.float64, device="cuda")

    def unpinned(lo, hi):
        run = lm._batch_iterations(GS._lanes(batch.params, lo, hi), tuple(GS._lanes(b, lo, hi) for b in batch.blocks),
                                   layout, batch.free[lo:hi], args.iterations, lam0[lo:hi], 1e-8, 1e-6, "cholesky")
        with full_fp32():
            return lm.run_lockstep([run])[0][0]

    step = G // args.shards
    for backend in ("default", "cusolver"):
        torch.backends.cuda.preferred_linalg_library(backend)
        whole = unpinned(0, G)
        parts = [unpinned(lo, lo + step) for lo in range(0, G, step)]
        cut = GS._stack_params([GS._group(p, k) for p in parts for k in range(step)])
        same = all(torch.equal(getattr(cut, f), getattr(whole, f)) for f in FIELDS)
        print(f"[unpinned, {backend}] {G} lanes in one call against {args.shards} calls of {step}: bit for bit "
              f"{same}; per leaf (largest |difference|, largest |value|): {_leaf_gaps(cut, whole)}")
    torch.backends.cuda.preferred_linalg_library("default")
    one, one_info = GS.solve_group_batch(copy.deepcopy(batch), True, max_iterations=args.iterations)
    sh, sh_info = GS.solve_group_batch(copy.deepcopy(batch), True, max_iterations=args.iterations,
                                       devices=["cuda:0"] * args.shards)
    same = all(torch.equal(getattr(sh, f), getattr(one, f)) for f in FIELDS)
    print(f"[solve_group_batch] one device LM {one_info.iterations.tolist()}, {args.shards} shards LM "
          f"{sh_info.iterations.tolist()}; bit for bit {same}; per leaf: {_leaf_gaps(sh, one)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
