"""Where the port's calibration of chip_smoke.py's phase-9 survey lands, pass
by pass, with the relax problems in float32 and in float64 from one state.

Renders phase 9's scene (chip_smoke.py's ``FULL`` survey over ``RELIEF_M`` of
relief, geotags' focal ``FOCAL_TAG_FACTOR`` above the truth, exposure gains)
on the card as ``--format`` files, runs INITIAL_PROCESSING in float32 (the
state from which a float32 run once missed the focal by 10 %), then forks
that state into one pipeline per relax dtype and drives each through
MESH_REFINEMENT; each MESH_REFINEMENT end state is forked
again into both dtypes and driven through CAMERA_PARAMETER_RELAX and
FINAL_GLOBAL_RELAX. Every pass prints its mesh size, LM iterations, final
costs, the focal length and the orientation and mesh-height errors against
the ground truth. ``--save DIR`` keeps each MESH_REFINEMENT end state
(``torch.load(..., weights_only=False)`` reads it back)::

    python tools/torch_focal_basin.py --format jpg --save states
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as CS  # noqa: E402
from opencalibration_tpu_torch.bench import bench_e2e as BE  # noqa: E402
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState  # noqa: E402
from opencalibration_tpu_torch.testing import survey as S  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the pipeline's state after INITIAL_PROCESSING; everything else is per state
_STATE = ("graph", "geocoord", "model_store", "_model_key_to_id", "gps_positions", "surfaces", "_state",
          "_state_run_count", "_edges_version")


def fork(p, dtype):
    """A new pipeline in ``dtype`` holding a deep copy of ``p``'s state."""
    q = Pipeline(device="cuda", dtype=dtype)
    for name in _STATE:
        setattr(q, name, copy.deepcopy(getattr(p, name)))
    for name in ("_mesh_grid_level", "_mesh_level_triangles"):
        if hasattr(p, name):
            setattr(q, name, getattr(p, name))
    return q


def _errors(p, paths, positions, quats):
    nodes = CS._by_path(p)
    ang = np.asarray([CS._angles_deg(nodes[path].orientation, quats[i]) for i, path in enumerate(paths)
                      if path in nodes])  # INITIAL_PROCESSING adds the images batch by batch
    mesh = p.surfaces[0].mesh if p.surfaces else None
    if mesh is None or mesh.num_vertices == 0:
        return ang, np.full(1, np.nan)
    herr, n_in = CS._relief_error(mesh.vertices, positions, CS._local_offset(p, positions))
    return ang, (herr if n_in else np.full(1, np.nan))


class _CostLog(BE.SolveLog):
    """Each relax solve's LM iterations and final cost per lane."""

    def record(self, solve, batch, pre_solve, kw, out):
        solve["cost"] = out[1].final_cost.reshape(-1).tolist()


def drive(p, label, until, paths, positions, quats):
    """``iterate_once`` until the state ``until``, one line per pass."""
    with _CostLog() as log:
        while p.get_state() != until:
            state, rc, n = p.get_state(), p.state_run_count(), len(log.solves)
            t0 = time.perf_counter()
            p.iterate_once()
            ang, herr = _errors(p, paths, positions, quats)
            mesh = p.surfaces[0].mesh if p.surfaces else None
            size = f"{mesh.num_vertices} v / {mesh.num_triangles} t" if mesh is not None else "no mesh"
            print(f"[{label}] {state} {rc} (level {getattr(p, '_mesh_grid_level', None)}, {size}): "
                  f"{time.perf_counter() - t0:.1f} s, LM/cost {[list(zip(x['lm'], x['cost'])) for x in log.solves[n:]]}; focal "
                  f"{float(p.model_store[1].focal_length_pixels):.4f} px, orientations median {np.median(ang):.4f} "
                  f"max {ang.max():.4f} deg, heights median {np.median(herr):.4f} max {herr.max():.4f} m", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--format", choices=("jpg", "netpbm"), default="jpg")
    ap.add_argument("--save", help="directory to write each MESH_REFINEMENT end state to (torch.save)")
    args = ap.parse_args(argv)
    print(torch.cuda.get_device_name(0))
    cfg = CS.FULL
    with tempfile.TemporaryDirectory() as d:
        paths, positions, quats = S.write_survey(
            d, cfg["rows"], cfg["cols"], spacing=CS.SPACING, width=cfg["width"], height=cfg["height"],
            focal=cfg["focal"], focal_px_tag=CS.FOCAL_TAG_FACTOR * cfg["focal"], texture=cfg["texture"],
            relief_amplitude=CS.RELIEF_M, relief_wavelength=CS.RELIEF_WAVELENGTH_M, color=True,
            gains=S.survey_gains(cfg["rows"] * cfg["cols"], spread=CS.GAIN_SPREAD), fmt=args.format,
            device="cuda")
        p = Pipeline(device="cuda", dtype=torch.float32)
        p.add(paths)
        drive(p, "ip float32", PipelineState.MESH_REFINEMENT, paths, positions, quats)
    refined = {}
    for name, dtype in DTYPES.items():
        q = fork(p, dtype)
        drive(q, f"mesh {name}", PipelineState.CAMERA_PARAMETER_RELAX, paths, positions, quats)
        refined[name] = q
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save(dict({k: getattr(q, k) for k in _STATE}, positions=positions, quats=quats, paths=paths),
                       os.path.join(args.save, f"mesh_{name}.pt"))
    for mesh_name, q in refined.items():
        for name, dtype in DTYPES.items():
            r = fork(q, dtype)
            drive(r, f"mesh {mesh_name} -> camera {name}", PipelineState.GENERATE_THUMBNAIL, paths, positions, quats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
