"""End-to-end pipeline benchmark of the port at survey scale (twin of the
repository's bench_e2e.py).

Runs the port's real ``Pipeline`` (JPEG decode, batched extraction, the link
through the Hamming top-2 kernel, the grouped relax, mesh refinement, the
camera-parameter relax, the final relax, and with ``BENCH_E2E_ORTHO`` the
ortho tail) on a synthetic survey written to disk, and prints one JSON line
per survey size: images a second end to end, LM iterations a second in the
relax states, the pose and intrinsics errors against the render's truth,
and beside the twin's keys the device (the card's name and power limit),
peak device memory, the seconds of each state, each state's relax solves,
the Hamming kernel's launches, and for a resumed run the state it resumed
in and the nodes its roll-back kept::

    python -m opencalibration_tpu_torch.bench.bench_e2e [n_images ...]   (default: 100 1000)

On the CPU: ``run_config(n, device="cpu")``. The environment is bench_e2e.py's:

- ``BENCH_E2E_ORTHO=dir``: after the calibration states, run GENERATE_LAYERS,
  COLOR_BALANCE and BLEND_LAYERS and write ortho.tif, dsm.tif and
  camera_ids.tif there; ``BENCH_E2E_ORTHO_MP`` caps the orthomosaic's
  megapixels (default 64).
- ``BENCH_E2E_CHECKPOINT=dir``: save a checkpoint on every state transition,
  and every ``BENCH_E2E_IP_CKPT_EVERY`` iterates (default 8) of
  INITIAL_PROCESSING, with ``ip_sidecar.json`` beside it. A relaunch with the
  same directory resumes where the last run stopped, without losing or
  repeating an image. The sidecar is the JAX package's file, so either
  package resumes from the other's. Times of a resumed run cover the resumed
  part only.
- ``BENCH_E2E_STOP_AFTER=STATE``: stop once that state completes.
- ``BENCH_E2E_BATCH``: INITIAL_PROCESSING's batch size (default 64).

Surveys are seeded and cached under ``.bench_surveys/torch_<rows>x<cols>``
at the repository root, apart from the JAX package's: the two renders differ
in their last bits, so the two writers' bytes differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.parallel import group_solver as GS
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.relax import lm as LM
from opencalibration_tpu_torch.testing import survey as S
from opencalibration_tpu_torch.utils import performance as perf

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repository's
SURVEY_ROOT = os.path.join(ROOT, ".bench_surveys")
IP_CKPT_EVERY = 8  # mid-INITIAL_PROCESSING checkpoint cadence (iterates), BENCH_E2E_IP_CKPT_EVERY
# the states whose seconds make ``relax_wall_s``, as in bench_e2e.py
RELAX_STATES = ("INITIAL_PROCESSING", "INITIAL_GLOBAL_RELAX", "CAMERA_PARAMETER_RELAX", "FINAL_GLOBAL_RELAX")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_line(device) -> str:
    """The device a result was measured on: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[dev.index or 0]


def survey_grid(n_images: int):
    """(rows, cols) of bench_e2e.py's survey of about ``n_images`` images."""
    rows = max(2, int(np.sqrt(n_images / 1.5)))
    return rows, max(2, (n_images + rows - 1) // rows)


def bench_survey(n_images: int, *, device):
    """The survey bench_e2e.py writes (gray JPEG at 320 x 240, quality 98,
    15 m apart), rendered on ``device`` the first time and read from the
    cache after. Returns (paths, positions, quats, seconds)."""
    rows, cols = survey_grid(n_images)
    directory = os.path.join(SURVEY_ROOT, f"torch_{rows}x{cols}")
    meta_path = os.path.join(directory, "survey_meta.json")
    t0 = time.perf_counter()
    if not os.path.exists(meta_path):
        os.makedirs(directory, exist_ok=True)
        paths, positions, quats = S.write_survey(directory, rows, cols, fmt="jpg",
                                                 jpeg_quality=S.BENCH_JPEG_QUALITY, device=device)
        # the list is written last, so a cut write leaves none and the next run writes again
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(files=[os.path.basename(p) for p in paths], positions=positions.tolist(),
                           quats=quats.tolist()), f)
        os.replace(tmp, meta_path)
    with open(meta_path) as f:
        meta = json.load(f)
    paths = [os.path.join(directory, name) for name in meta["files"]]
    return paths, np.asarray(meta["positions"]), np.asarray(meta["quats"]), time.perf_counter() - t0


def _paths_of(p, ids) -> list:
    return [p.graph.get_node(nid).payload.path for nid in ids if p.graph.get_node(nid) is not None]


def _save_ip_sidecar(p, ckpt: str) -> None:
    """Write ``ip_sidecar.json`` beside a checkpoint: what the checkpoint
    does not hold of INITIAL_PROCESSING, namely the queue not yet consumed,
    the batch loaded but not linked and the batch linked but not relaxed.

    It carries the graph's node and edge counts and the state, so that a run
    cut between ``save_checkpoint`` and this write (a newer graph beside a
    stale sidecar) is found on resume: the node count grows with every
    batch, so a stale pair never matches. Written to a temporary file and
    renamed, so a reader never sees half of it. Keys, order and meaning are
    bench_e2e.py's."""
    tmp = os.path.join(ckpt, "ip_sidecar.json.tmp")
    with open(tmp, "w") as f:
        json.dump(dict(
            remaining=list(p._add_queue),
            pending=_paths_of(p, p._prev_loaded_ids),
            linked=_paths_of(p, p._prev_linked_ids),
            graph_nodes=p.graph.size_nodes(),
            graph_edges=p.graph.size_edges(),
            state=p.get_state(),
        ), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt, "ip_sidecar.json"))


def _resume_mid_ip(p, ckpt: str) -> None:
    """Apply the sidecar to a pipeline loaded from its checkpoint: remove the
    nodes of the two batches in flight (loaded but not linked, linked but
    not relaxed) and queue their paths again ahead of the unconsumed queue,
    so the run goes on as from the last batch processed in full. A sidecar
    that is missing, unreadable or stale (its counts or state are not the
    checkpoint's) is ignored, and the run resumes from the checkpoint
    alone."""
    side_path = os.path.join(ckpt, "ip_sidecar.json")
    if not os.path.exists(side_path):
        return
    try:
        with open(side_path) as f:
            side = json.load(f)
    except (OSError, json.JSONDecodeError):
        print("  sidecar unreadable; resuming without it", file=sys.stderr)
        return
    if side.get("graph_nodes") is not None and (
        side["graph_nodes"] != p.graph.size_nodes()
        or side.get("graph_edges") != p.graph.size_edges()
        or side.get("state") not in (None, p.get_state())
    ):
        print("  sidecar fingerprint mismatch (stale pairing); ignoring it", file=sys.stderr)
        return
    requeue = set(side.get("pending", [])) | set(side.get("linked", []))
    if requeue:
        for nid in [nid for nid, node in list(p.graph.nodes()) if node.payload.path in requeue]:
            p.graph.remove_node(nid)
            p.gps_positions.pop(nid, None)
    in_graph = {node.payload.path for _, node in p.graph.nodes()}
    readd = [path for path in sorted(requeue) + list(side.get("remaining", [])) if path not in in_graph]
    if readd:
        p.add(readd)
        print(f"  re-queued {len(requeue)} in-flight + {len(side.get('remaining', []))} unconsumed images",
              file=sys.stderr, flush=True)


class SolveLog:
    """Records every relax solve while entered (the stage looks its solvers
    up by name): the solver, the pipeline's state (with a pipeline given),
    groups, the lanes the solver ran them in, the batch's tangent dimension
    and route ("cholesky", "cg", or "schur" for the joint shared-intrinsics
    solve), LM iterations per lane (one for the joint solve) and seconds to
    the read of the iterations, which waits for the solve. ``record`` is the
    hook for more fields of one solve."""

    _NAMES = ("solve_group_batch", "solve_group_batch_shared")

    def __init__(self, pipeline=None):
        self.pipeline = pipeline
        self.solves = []
        self._orig = {}

    def __enter__(self):
        for name in self._NAMES:
            self._orig[name] = getattr(ST, name)
            setattr(ST, name, self._recording(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(ST, name, fn)

    def record(self, solve: dict, batch, pre_solve, kw, out) -> None:
        """Called after each solve with its record, before the record is kept."""

    def _recording(self, name, solve):
        def recording(batch, pre_solve, *args, **kw):
            t0 = time.perf_counter()
            out = solve(batch, pre_solve, *args, **kw)
            lm = [int(i) for i in out[1].iterations.reshape(-1).tolist()]
            shared = name == "solve_group_batch_shared"
            G, D = batch.num_groups, len(kw.get("devices") or [batch.free.device])
            rec = dict(
                kind=name, state=self.pipeline.get_state() if self.pipeline is not None else None, groups=G,
                lanes=GS.num_lanes(G, D, shared=shared),
                T=batch.layout.dim, route="schur" if shared else LM.route(batch.layout.dim),
                lm=lm, seconds=time.perf_counter() - t0,
            )
            self.record(rec, batch, pre_solve, kw, out)
            self.solves.append(rec)
            return out

        return recording

    def by_state(self) -> dict:
        """Per state: solves, the most groups in one solve, the lane counts,
        the tangent dimensions and routes met, LM iterations summed over the
        lanes, and seconds."""
        out = {}
        for s in self.solves:
            d = out.setdefault(s["state"], dict(solves=0, max_groups=0, lanes=[], T=[], routes=[],
                                                 lm_iterations=0, seconds=0.0))
            d["solves"] += 1
            d["max_groups"] = max(d["max_groups"], s["groups"])
            d["lm_iterations"] += sum(s["lm"])
            d["seconds"] += s["seconds"]
            for key, value in (("lanes", s["lanes"]), ("routes", s["route"])):
                if value not in d[key]:
                    d[key].append(value)
            d["T"] = [min(d["T"] + [s["T"]]), max(d["T"] + [s["T"]])]
        return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _intrinsics_errors(p) -> dict:
    """The recovered intrinsics against the render's truth: a
    distortion-free pinhole at ``S.FOCAL`` px with the principal point at the
    image centre. Medians over the camera models."""
    fe, pe, re_ = [], [], []
    for m in p.model_store.values():
        fe.append(abs(float(_np(m.focal_length_pixels)) - S.FOCAL))
        pp = _np(m.principal_point).astype(float).reshape(-1)[:2]
        pe.append(float(np.linalg.norm(pp - [S.IMG_W / 2, S.IMG_H / 2])))
        re_.append(float(np.linalg.norm(_np(m.radial_distortion))))
    if not fe:
        return {}
    return dict(focal_err_px=round(float(np.median(fe)), 3), principal_err_px=round(float(np.median(pe)), 3),
                radial_err_norm=round(float(np.median(re_)), 5))


def make_pipeline(batch_size: int, *, device) -> Pipeline:
    """The pipeline as bench_e2e.py sets it up: no thumbnail mosaic, no dense
    mesh, the ortho outputs where ``BENCH_E2E_ORTHO`` names a directory."""
    p = Pipeline(batch_size=batch_size, parallelism=16, device=device)
    p.generate_thumbnails = False
    p.skip_dense_mesh = True
    ortho_dir = os.environ.get("BENCH_E2E_ORTHO") or None
    if ortho_dir:
        os.makedirs(ortho_dir, exist_ok=True)
        p.ortho_path = os.path.join(ortho_dir, "ortho.tif")
        p.dsm_path = os.path.join(ortho_dir, "dsm.tif")
        p.camera_id_path = os.path.join(ortho_dir, "camera_ids.tif")
        p.ortho_max_megapixels = float(os.environ.get("BENCH_E2E_ORTHO_MP", "64"))
    return p


def run_config(n_images: int, batch_size: int = 64, stop_after: str | None = None, *, device="cuda") -> dict:
    """Run the survey of about ``n_images`` images through the port's
    pipeline on ``device`` to COMPLETE (or to the end of ``stop_after``) and
    return the result dict."""
    every = int(os.environ.get("BENCH_E2E_IP_CKPT_EVERY", str(IP_CKPT_EVERY)))
    paths, positions, _, gen_s = bench_survey(n_images, device=device)
    n = len(paths)

    perf.enable_performance_counters(True)
    perf.reset_performance_counters()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = hamming_cuda.hamming_top2.launches
    p = make_pipeline(batch_size, device=device)
    ortho_dir = os.environ.get("BENCH_E2E_ORTHO") or None
    ckpt = os.environ.get("BENCH_E2E_CHECKPOINT") or None
    resumed = False
    if ckpt and os.path.exists(os.path.join(ckpt, "metadata.json")):
        resumed = p.load_checkpoint(ckpt)
        print(f"resumed from {ckpt} at {p.get_state()}", file=sys.stderr)
    resumed_at = p.get_state() if resumed else None
    resume_kept = None
    if resumed:
        _resume_mid_ip(p, ckpt)
        resume_kept = p.graph.size_nodes()
        # the ortho job (layers, correspondences) lives in memory only: a
        # resume inside the ortho tail renders its layers again
        if ortho_dir and p.get_state() in (PipelineState.COLOR_BALANCE, PipelineState.BLEND_LAYERS):
            p.resume_from_state(PipelineState.GENERATE_LAYERS)
            print("  ortho job not persisted: rewound to GENERATE_LAYERS", file=sys.stderr)
    else:
        p.add(paths)

    state_s = {}
    _sync(device)
    t0 = time.perf_counter()
    prev = None
    with SolveLog(p) as solves:
        for it in range(100000):
            cur, rc = p.get_state(), p.state_run_count()
            t1 = time.perf_counter()
            state = p.iterate_once()
            _sync(device)
            took = time.perf_counter() - t1
            state_s[cur] = state_s.get(cur, 0.0) + took
            if cur != prev or (it and it % 3 == 0):
                if prev is not None:
                    print(perf.total_performance_summary(), file=sys.stderr, flush=True)
                prev = cur
            print(f"  [{time.perf_counter() - t0:7.1f}s] {cur} rc={rc} ({took:.1f}s)", file=sys.stderr, flush=True)
            if state == "DONE":
                break
            if ckpt and state != cur:
                # on the transition itself, as the runner saves
                p.save_checkpoint(ckpt)
                _save_ip_sidecar(p, ckpt)
            elif ckpt and cur == PipelineState.INITIAL_PROCESSING and it % every == every - 1:
                # INITIAL_PROCESSING is one long state with no transition to
                # save on: save every few batches, with the sidecar that lets
                # a resume roll back the batches in flight
                t_ck = time.perf_counter()
                p.save_checkpoint(ckpt)
                _save_ip_sidecar(p, ckpt)
                print(f"  [mid-IP checkpoint {time.perf_counter() - t_ck:.1f}s]", file=sys.stderr, flush=True)
            if state == PipelineState.COMPLETE:
                break
            if stop_after is not None and cur == stop_after and state != cur:
                break
    wall = time.perf_counter() - t0

    lm_iters = perf.get_event_count("lm iterations")
    relax_wall = sum(perf.get_timer_total(f"state {s}") for s in RELAX_STATES)
    node_paths = [node.payload.path for _, node in p.graph.nodes()]
    by_path = {node.payload.path: np.asarray(node.payload.position) for _, node in p.graph.nodes()}
    rec = np.stack([by_path[path] for path in paths if path in by_path])
    gt = np.stack([positions[i] for i, path in enumerate(paths) if path in by_path])
    # the pipeline's frame starts at its first geotag, the truth's at the survey origin
    errs = np.linalg.norm((rec - rec.mean(0)) - (gt - gt.mean(0)), axis=1).tolist()
    print(perf.total_performance_summary(), file=sys.stderr)
    result = dict(
        n_images=n,
        survey_gen_s=round(gen_s, 2),
        wall_s=round(wall, 2),
        images_per_sec_e2e=round(n / wall, 3),
        lm_iterations=int(lm_iters),
        lm_iters_per_sec=round(lm_iters / max(relax_wall, 1e-9), 2),
        relax_wall_s=round(relax_wall, 2),
        n_edges=p.graph.size_edges(),
        median_pose_err_m=round(float(np.median(errs)), 3) if errs else None,
        final_state=p.get_state(),
    )
    result.update(_intrinsics_errors(p))
    if ortho_dir:
        result["ortho_artifacts"] = {f: os.path.getsize(os.path.join(ortho_dir, f))
                                     for f in sorted(os.listdir(ortho_dir))}
    result.update(
        device=device_line(device),
        n_nodes=len(node_paths),
        n_survey_paths_in_graph=len(set(node_paths) & set(paths)),
        resumed_at=resumed_at,
        resume_kept_nodes=resume_kept,
        state_s=state_s,
        solves=solves.by_state(),
        peak_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if torch.device(device).type == "cuda" else None),
        hamming_launches=hamming_cuda.hamming_top2.launches - launches0,
    )
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    stop_after = os.environ.get("BENCH_E2E_STOP_AFTER") or None
    batch_size = int(os.environ.get("BENCH_E2E_BATCH", "64"))
    for n in [int(a) for a in argv] or [100, 1000]:
        print(json.dumps(run_config(n, batch_size=batch_size, stop_after=stop_after)), flush=True)


if __name__ == "__main__":
    main()
