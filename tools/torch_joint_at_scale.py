"""The shared-intrinsics joint solver at full size (ROADMAP P5) in the port
and in the JAX package from one state: does the focal it returns come from
the algorithm or from the port?

``capture OUT`` (needs a CUDA device) renders chip_smoke.py's phase-9 survey
(24 colour JPEG images at 1600 x 1200 over the relief, geotags' focal 5 %
above the truth), runs the port's pipeline with its defaults (float64) to
the entry of CAMERA_PARAMETER_RELAX, and writes that state with
``save_checkpoint`` to ``OUT/ckpt`` (both packages read it) and the ground
truth to ``OUT/truth.npz``. Then, on the card, from the state in memory and
from the checkpoint read back, it prints the focal of pass 0's relax (focal
free) solved as phase 14 solves it: three intrinsics groups of 8, one joint
solve; and as the pipeline's default solves it: one group::

    python tools/torch_joint_at_scale.py capture chiprun_out/joint

``replay OUT`` reads the checkpoint on the CPU into the port and into the
JAX package (float64 on its CPU backend, as its tests run; this mode imports
it) and prints the same solves of each package, and how far the two
packages' results are apart::

    python tools/torch_joint_at_scale.py replay chiprun_out/joint

``passes OUT`` reads the same checkpoint on the CPU into the port's
``Pipeline`` and the JAX package's (float64, as ``replay``) and runs all six
passes of CAMERA_PARAMETER_RELAX in each (one intrinsics group, the
pipeline's default below 150 images), printing after every pass the focal,
principal point and radial terms of each package, their focal error against
the truth and how far the two packages are apart (ROADMAP P4: is the focal
that opening the radial tiers costs the port's or the reference's?)::

    python tools/torch_joint_at_scale.py passes OUT
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _port_solve(p, group_size, device):
    """Pass 0's relax of the port's pipeline state ``p`` with intrinsics
    groups of ``group_size``: (groups, focal, LM iterations, initial and
    final cost, seconds)."""
    import torch

    from opencalibration_tpu_torch.parallel import group_solver as GS
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions

    graph, gps, models, surfaces = (copy.deepcopy(x) for x in (p.graph, p.gps_positions, p.model_store, p.surfaces))
    saved = ST.INTRINSICS_GROUP_SIZE
    ST.INTRINSICS_GROUP_SIZE = group_size
    try:
        stage = ST.RelaxStage(device=device, dtype=torch.float64)
        stage.init(graph, [], gps, models, relax_all=True, disable_parallelism=False,
                   options=RelaxOptions(orientation=True, ground_mesh=True, focal=True))
        stage.dispatch(graph, surfaces)
    finally:
        ST.INTRINSICS_GROUP_SIZE = saved
    batch, pre_solve = stage.last_plan.batch, stage.last_plan.pre_solve
    t0 = time.perf_counter()
    solve = GS.solve_group_batch_shared if batch.shared_intrinsics else GS.solve_group_batch
    solved, info = solve(batch, pre_solve, max_iterations=100)
    focal = float(GS.fetch_solved(solved).focal[0, 0])
    return (batch.num_groups, focal, int(info.iterations.reshape(-1)[0]), float(info.initial_cost.reshape(-1)[0]),
            float(info.final_cost.reshape(-1)[0]), time.perf_counter() - t0)


def _jax_solve(p, group_size):
    """The same with the JAX package's stage and solvers."""
    from opencalibration_tpu.parallel import group_solver as JGS
    from opencalibration_tpu.pipeline import stages as JST
    from opencalibration_tpu.relax.problem_builder import RelaxOptions

    graph, gps, models, surfaces = (copy.deepcopy(x) for x in (p.graph, p.gps_positions, p.model_store, p.surfaces))
    saved = JST.INTRINSICS_GROUP_SIZE
    JST.INTRINSICS_GROUP_SIZE = group_size
    try:
        stage = JST.RelaxStage()
        stage.init(graph, [], gps, models, relax_all=True, disable_parallelism=False,
                   options=RelaxOptions(orientation=True, ground_mesh=True, focal=True))
        t0 = time.perf_counter()
        stage.dispatch(graph, surfaces)  # builds and solves
        batch, solved, info = stage._inflight[:3]
        solved = JGS.fetch_solved(solved)
    finally:
        JST.INTRINSICS_GROUP_SIZE = saved
    it = np.ravel(np.asarray(info.iterations))
    return (batch.num_groups, float(np.asarray(solved.focal)[0, 0]), int(it[0]),
            float(np.ravel(np.asarray(info.initial_cost))[0]), float(np.ravel(np.asarray(info.final_cost))[0]),
            time.perf_counter() - t0)


def _line(label, out, true_focal):
    groups, focal, iters, c0, c1, seconds = out
    print(f"[{label}] {groups} group(s): focal {focal:.4f} px ({100 * (focal / true_focal - 1):+.4f} % against the "
          f"true {true_focal}), {iters} LM iterations, cost {c0:.6g} -> {c1:.6g}, {seconds:.1f} s (host clock, "
          f"build excluded)", flush=True)


def capture(out, group_size):
    import torch

    import chip_smoke as CS
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState

    print(torch.cuda.get_device_name(0))
    os.makedirs(out, exist_ok=True)
    cfg = CS.FULL
    with tempfile.TemporaryDirectory() as d:
        p, paths, positions, quats, _, _ = CS.phase_pipeline_full_size(
            d, CS.RELIEF_M, "capture", focal_px_tag=CS.FOCAL_TAG_FACTOR * cfg["focal"], color=True, fmt="jpg")
        while p.get_state() != PipelineState.CAMERA_PARAMETER_RELAX:
            p.iterate_once()
    np.savez(os.path.join(out, "truth.npz"), positions=positions, quats=quats, paths=np.asarray(paths),
             focal=cfg["focal"])
    if not p.save_checkpoint(os.path.join(out, "ckpt")):
        raise RuntimeError("save_checkpoint failed")
    q = Pipeline(device="cuda")
    if not q.load_checkpoint(os.path.join(out, "ckpt")):
        raise RuntimeError("load_checkpoint failed")
    for label, state in (("card, in memory", p), ("card, from the checkpoint", q)):
        for size in (group_size, 150):
            _line(f"{label}, groups of {size}", _port_solve(state, size, "cuda"), cfg["focal"])
    return 0


def _load_both(out):
    """The checkpoint ``OUT/ckpt`` loaded on the CPU into the port's
    ``Pipeline`` and into the JAX package's (float64 on its CPU backend, as
    its tests run), and the true focal."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline

    ckpt = os.path.join(out, "ckpt")
    port, ref = Pipeline(device="cpu"), JPipeline()
    if not (port.load_checkpoint(ckpt) and ref.load_checkpoint(ckpt)):
        raise RuntimeError("load_checkpoint failed")
    return port, ref, float(np.load(os.path.join(out, "truth.npz"))["focal"])


def replay(out, group_size):
    port, ref, true_focal = _load_both(out)
    for size in (group_size, 150):
        t = _port_solve(port, size, "cpu")
        _line(f"port, CPU, groups of {size}", t, true_focal)
        j = _jax_solve(ref, size)
        _line(f"JAX package, CPU, groups of {size}", j, true_focal)
        print(f"[groups of {size}] focal port against JAX: {abs(t[1] - j[1]) / j[1]:.3e} relative", flush=True)
    return 0


def _model_values(model):
    """(focal, principal point [2], radial [3]) of a camera model of either
    package, as float64 numpy."""
    def arr(x):
        return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64).reshape(-1)

    return (float(arr(model.focal_length_pixels)[0]), arr(model.principal_point)[:2],
            arr(model.radial_distortion)[:3])


def passes(out):
    from opencalibration_tpu_torch.pipeline.pipeline import PipelineState

    port, ref, true_focal = _load_both(out)
    state = PipelineState.CAMERA_PARAMETER_RELAX
    if port.get_state() != state or ref.get_state() != state:
        raise RuntimeError(f"the checkpoint is at {port.get_state()}, not at {state}")
    (mid,) = sorted(port.model_store)
    worst = 0.0
    f, pp, k = _model_values(port.model_store[mid])
    print(f"[entry] focal {f:.6f} px ({100 * (f / true_focal - 1):+.4f} %), principal {pp.tolist()}, "
          f"radial {k.tolist()}", flush=True)
    while port.get_state() == state:
        rc = port.state_run_count()
        if ref.get_state() != state or ref.state_run_count() != rc:
            raise RuntimeError(f"the packages part at pass {rc}: {ref.get_state()} run {ref.state_run_count()}")
        t0 = time.perf_counter()
        port.iterate_once()
        t1 = time.perf_counter()
        ref.iterate_once()
        t2 = time.perf_counter()
        (fp, ppp, kp), (fj, ppj, kj) = (_model_values(port.model_store[mid]), _model_values(ref.model_store[mid]))
        rel = abs(fp - fj) / abs(fj)
        rad = float(np.max(np.abs(kp - kj)))
        worst = max(worst, rel, float(np.max(np.abs(ppp - ppj))) / abs(fj),
                    rad / max(float(np.max(np.abs(kj))), 1e-300) if rad else 0.0)
        for name, f, pp, k in (("port", fp, ppp, kp), ("JAX package", fj, ppj, kj)):
            print(f"[pass {rc}, {name}] focal {f:.10f} px ({100 * (f / true_focal - 1):+.4f} % against the true "
                  f"{true_focal}), principal {pp.tolist()}, radial {k.tolist()}", flush=True)
        print(f"[pass {rc}] port against JAX: focal {rel:.3e} relative, radial {rad:.3e}, principal "
              f"{float(np.max(np.abs(ppp - ppj))):.3e} px; {t1 - t0:.1f} s / {t2 - t1:.1f} s (host clock)", flush=True)
    print(f"[passes] largest relative difference over the six passes (focal; principal point over the focal; "
          f"radial over its largest term): {worst:.3e}; both end at "
          f"{port.get_state()} / {ref.get_state()}", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("capture", "replay", "passes"))
    ap.add_argument("out")
    ap.add_argument("--group-size", type=int, default=8, help="images per intrinsics group (phase 14: 8)")
    args = ap.parse_args(argv)
    if args.mode == "passes":
        return passes(args.out)
    return (capture if args.mode == "capture" else replay)(args.out, args.group_size)


if __name__ == "__main__":
    sys.exit(main())
