"""Launches, host syncs and wall time of one LM iteration of the port on the
card (ROADMAP P1), on the relax problems of chip_smoke.py's phase-7 survey.

Renders phase 7's flat survey (``chip_smoke.MULTI``: 7 x 8 images at
1600 x 1200, 12 m apart) on the card, runs INITIAL_PROCESSING with the
pipeline's defaults, and captures the built problems of the first
MESH_REFINEMENT pass (two pose groups past ``POSE_GROUP_SIZE``) from the
batch that pass hands ``solve_group_batch``. Then, with the stop tests off,
it solves

* one group alone (``lm.solve``),
* the same group as a batch of one lane (``lm.solve_batch``), and
* the batch of all groups (``lm.solve_batch``, one lane a group),

for 1 and for ``--iterations`` LM iterations, under ``torch.profiler`` and
again without it, and prints per iteration (the difference of the two runs
over the extra iterations): kernels the device ran, kernel launches and
synchronising host calls (``cudaStreamSynchronize``, device-to-host copies)
the profiler saw, and the wall time (median of three unprofiled runs, host
clock with ``torch.cuda.synchronize()``)::

    python tools/torch_lm_profile.py --iterations 6

``--pass-through`` then drives the pipeline on through MESH_REFINEMENT and
FINAL_GLOBAL_RELAX and prints seconds per pass.
``--compare-ip`` first runs INITIAL_PROCESSING of the same survey on the
serial and on the batched route and prints each one's orientation error
against the ground truth. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as CS  # noqa: E402
from opencalibration_tpu_torch.parallel import group_solver as GS  # noqa: E402
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState  # noqa: E402
from opencalibration_tpu_torch.relax import lm as LM  # noqa: E402
from opencalibration_tpu_torch.testing import survey as S  # noqa: E402

_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _counts(fn):
    """(device kernels, launch calls, synchronising calls) of one ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = launches = syncs = 0
    for e in prof.events():
        if e.is_user_annotation:  # the program's spans, on the host and over their kernels
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
        elif e.name in _LAUNCH:
            launches += 1
        elif "Synchronize" in e.name or e.name.startswith("cudaMemcpy"):
            syncs += 1
    return kernels, launches, syncs


def _seconds(fn):
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def per_iteration(label, solve, iterations):
    """Profile ``solve(k)`` for k = 1 and ``iterations``; print the counts of
    one iteration."""
    solve(1)  # warm-up
    c1, cn = _counts(lambda: solve(1)), _counts(lambda: solve(iterations))
    t1, tn = _seconds(lambda: solve(1)), _seconds(lambda: solve(iterations))
    k = iterations - 1
    kern, launch, sync = ((b - a) / k for a, b in zip(c1, cn))
    print(f"[lm-profile] {label}: per LM iteration {kern:.1f} device kernels, {launch:.1f} launch calls, "
          f"{sync:.1f} synchronising calls, {1e3 * (tn - t1) / k:.3f} ms wall (one iteration alone "
          f"{1e3 * t1:.3f} ms with the set-up)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--pass-through", action="store_true")
    ap.add_argument("--compare-ip", action="store_true")
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0), flush=True)
    cfg = CS.MULTI
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths, _, quats_gt = S.write_survey(d, cfg["rows"], cfg["cols"], spacing=CS.SPACING, width=cfg["width"],
                                            height=cfg["height"], focal=cfg["focal"], texture=cfg["texture"],
                                            device="cuda")
        for batched in (False, True) if args.compare_ip else ():
            q = Pipeline(device="cuda")
            q._relax_stage.use_batched_solver = batched
            q.add(paths)
            while q.get_state() == PipelineState.INITIAL_PROCESSING:
                q.iterate_once()
            CS._orientation_error(q, paths, quats_gt, f"ip {'batched' if batched else 'serial'}", bounded=False)
        p = Pipeline(device="cuda")
        p.add(paths)
        while p.get_state() == PipelineState.INITIAL_PROCESSING:
            p.iterate_once()
        print(f"[lm-profile] {len(paths)} images through INITIAL_PROCESSING in {time.perf_counter() - t0:.1f} s",
              flush=True)
        with CS._SolveRecorder(keep_last=True) as rec:  # the pass makes one batched solve
            t0 = time.perf_counter()
            p.iterate_once()
            torch.cuda.synchronize()
            print(f"[lm-profile] first MESH_REFINEMENT pass {time.perf_counter() - t0:.2f} s", flush=True)
    batch = rec.last["batch"]
    builts = batch.builts
    route = LM.route(batch.layout.dim)
    print(f"[lm-profile] {len(builts)} groups, tangent dims {[b.layout.dim for b in builts]}, batch layout "
          f"T = {batch.layout.dim} -> {route}", flush=True)
    off = dict(parameter_tolerance=0.0, function_tolerance=0.0, linear_solver=route)
    b0 = builts[0]
    per_iteration("one group, lm.solve", lambda k: LM.solve(b0.params, b0.blocks, b0.layout, b0.free_mask,
                                                             max_iterations=k, **off), args.iterations)
    one = GS.build_group_batch([b0])
    per_iteration("one group in one lane, lm.solve_batch",
                  lambda k: LM.solve_batch(one.params, one.blocks, one.layout, one.free, max_iterations=k, **off),
                  args.iterations)
    G = GS.num_lanes(batch.num_groups)
    padded = GS.pad_lanes(batch, G)
    per_iteration(f"{batch.num_groups} groups in {G} lanes, lm.solve_batch",
                  lambda k: LM.solve_batch(padded.params, padded.blocks, padded.layout, padded.free,
                                           max_iterations=k, **off), args.iterations)
    if args.pass_through:
        p.skip_camera_param_relax = True
        while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
            state, t0 = p.get_state(), time.perf_counter()
            p.iterate_once()
            torch.cuda.synchronize()
            print(f"[lm-profile] {state}: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
