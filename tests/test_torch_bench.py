"""The port's bench twins (opencalibration_tpu_torch/bench) against the
repository's bench.py and bench_e2e.py, on the CPU at 320 x 240.

- The mid-INITIAL_PROCESSING resume (the three cases of
  tests/test_bench_resume.py) on a 2 x 6 survey in batches of 2, cut after
  four iterates, where the roll-back is partial: two batches relaxed, the
  linked one with the nodes its edges reach and the loaded one pruned and
  queued again ahead of the unconsumed queue, the other relaxed nodes kept.
  Resumed by ``run_config`` from its checkpoint and sidecar (the re-queued
  images in one batch), the run holds the same image set as an
  uninterrupted run, every path of the survey, each once; a stale sidecar
  and a corrupt one are ignored.
- Across the packages, at the same cut: the JAX package's ``_resume_mid_ip``
  on a JAX ``Pipeline`` loaded from the port's checkpoint and sidecar
  re-queues the same paths in the same order and keeps the same nodes as
  the port's; its ``_save_ip_sidecar`` writes the same JSON, byte for byte.
- The bench survey on a 2 x 3 grid against tests/synthetic_survey.py's:
  the same file names, sidecars within 1e-9, decoded pixels within 1 level
  on at least 99 % of them (the renders differ in their last bits, so a
  pixel's 8-bit value may fall on the other side of a level; measured
  99.9976 % within 1, 99.939 % equal, at most 3 levels apart, sidecars
  equal),
  and the port's JPEG encoder at quality 98 byte for byte cv2's.
- ``build_workload`` against bench.py's: positions and pairs exactly, images
  within 1e-4 (float32 renders whose rays differ in their last bits, which
  moves a bilinear sample along the texture's slope: 1.27e-5 measured).
- ``run_config``'s result holds every key of bench_e2e.py's; ``SolveLog``
  records the lanes the solver pads a batch to, on one device and on
  several.
- The three twins import, and the survey writer runs, where jax, the JAX
  package, cv2 and PIL cannot be imported.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as JBENCH  # noqa: E402
import bench_e2e as JB  # noqa: E402
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline  # noqa: E402
from opencalibration_tpu_torch.bench import bench as TBENCH  # noqa: E402
from opencalibration_tpu_torch.bench import bench_e2e as TB  # noqa: E402
from opencalibration_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg  # noqa: E402
from opencalibration_tpu_torch.parallel import group_solver as TGS  # noqa: E402
from opencalibration_tpu_torch.pipeline.pipeline import PipelineState  # noqa: E402
from opencalibration_tpu_torch.testing import survey as TS  # noqa: E402
from tests import synthetic_survey as JS  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

# the resume's survey: 2 x 6 in batches of 2, eight iterates of
# INITIAL_PROCESSING. A batch links to each image's 10 nearest, so on a smaller
# survey the linked batch reaches every node and the roll-back empties the graph
N_IMAGES, BATCH, CUT = 12, 2, 4
RESUME_BATCH = N_IMAGES  # the relaunch takes what the roll-back re-queues in one batch
SURVEY_IMAGES = 6  # the 2 x 3 survey compared with tests/synthetic_survey.py's
SIDECAR_REL = 1e-9
PIXEL_LEVELS, PIXEL_SHARE = 1, 0.99
WORKLOAD_ATOL = 1e-4  # a level of an 8-bit image is 3.9e-3
# bench_e2e.py's result dict (bench_e2e.py:310-322 and _intrinsics_errors)
JAX_RESULT_KEYS = [
    "n_images", "survey_gen_s", "wall_s", "images_per_sec_e2e", "lm_iterations", "lm_iters_per_sec",
    "relax_wall_s", "n_edges", "median_pose_err_m", "final_state",
    "focal_err_px", "principal_err_px", "radial_err_norm",
]


def _graph_paths(p):
    return sorted(node.payload.path for _, node in p.graph.nodes())


def _iterate(p, n):
    for _ in range(n):
        assert p.get_state() == PipelineState.INITIAL_PROCESSING
        p.iterate_once()


def _load(ckpt, batch=BATCH):
    p = TB.make_pipeline(batch, device="cpu")
    assert p.load_checkpoint(ckpt)
    return p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bench survey (2 x 6) and a run of ``make_pipeline`` through
    INITIAL_PROCESSING that saves on its way: after ``CUT`` iterates
    checkpoint and sidecar to ``cut``, ``resume`` and ``stale``, with its
    queue and in-flight ids; after one more the checkpoint alone to
    ``stale`` (a newer graph beside the older sidecar). Then ``resumed``:
    ``run_config`` with the checkpoint directory ``resume``, to the end of
    INITIAL_PROCESSING, where it saves again."""
    root = tmp_path_factory.mktemp("bench")
    saved_root = TB.SURVEY_ROOT
    TB.SURVEY_ROOT = str(root / "surveys")
    dirs = {k: str(root / k) for k in ("cut", "resume", "stale")}
    mp = pytest.MonkeyPatch()
    try:
        paths = TB.bench_survey(N_IMAGES, device="cpu")[0]
        run = TB.make_pipeline(BATCH, device="cpu")
        run.add(paths)
        _iterate(run, CUT)
        cut = dict(queue=list(run._add_queue), loaded=list(run._prev_loaded_ids),
                   linked=list(run._prev_linked_ids), nodes=run.graph.size_nodes())
        for k in dirs:
            assert run.save_checkpoint(dirs[k])
            TB._save_ip_sidecar(run, dirs[k])
        _iterate(run, 1)
        assert run.save_checkpoint(dirs["stale"])
        del run

        mp.setenv("BENCH_E2E_CHECKPOINT", dirs["resume"])
        mp.delenv("BENCH_E2E_ORTHO", raising=False)
        resumed = TB.run_config(N_IMAGES, RESUME_BATCH, stop_after="INITIAL_PROCESSING", device="cpu")
    finally:
        mp.undo()
        TB.SURVEY_ROOT = saved_root
    return dict(paths=paths, resumed=resumed, cut=cut, dirs=dirs)


def test_run_config_returns_the_keys_of_bench_e2e(runs):
    r = runs["resumed"]
    missing = [k for k in JAX_RESULT_KEYS if k not in r]
    assert not missing, missing
    assert r["final_state"] == PipelineState.MESH_REFINEMENT
    assert r["n_images"] == N_IMAGES and r["device"] == "cpu" and r["peak_memory_gib"] is None
    assert set(r["state_s"]) == {"INITIAL_PROCESSING"}
    assert r["lm_iterations"] > 0 and r["solves"]["INITIAL_PROCESSING"]["lm_iterations"] == r["lm_iterations"]
    json.dumps(r)


def _rolled_back(ckpt):
    """The sidecar at ``ckpt`` and the port's pipeline loaded from the
    checkpoint with the sidecar applied."""
    side = json.load(open(os.path.join(ckpt, "ip_sidecar.json")))
    p = _load(ckpt)
    TB._resume_mid_ip(p, ckpt)
    return side, p


@pytest.mark.parametrize("name, groups, devices, lanes", [
    ("solve_group_batch", 1, 1, 1), ("solve_group_batch", 3, 1, 4), ("solve_group_batch", 5, 1, 8),
    ("solve_group_batch", 5, 3, 6), ("solve_group_batch", 4, 2, 4),
    ("solve_group_batch_shared", 5, 1, 5), ("solve_group_batch_shared", 5, 3, 6), ("solve_group_batch_shared", 2, 3, 2),
])
def test_solve_log_records_the_solvers_lanes(name, groups, devices, lanes):
    """Lanes as the solver pads them: bucketed to a power of two on one
    device, a multiple of the shard count on several; the joint solve
    unbucketed, over at most as many shards as groups."""
    batch = SimpleNamespace(num_groups=groups, layout=SimpleNamespace(dim=40), free=torch.zeros(groups, 40))
    info = SimpleNamespace(iterations=torch.arange(groups))
    log = TB.SolveLog()
    kw = {"devices": ["cpu"] * devices} if devices > 1 else {}
    log._recording(name, lambda b, pre, **k: (None, info))(batch, False, max_iterations=5, **kw)
    (rec,) = log.solves
    assert rec["lanes"] == lanes and rec["groups"] == groups and rec["lm"] == list(range(groups))
    assert rec["route"] == ("schur" if name.endswith("shared") else "cholesky") and rec["state"] is None
    assert TGS.num_lanes(groups, devices, shared=name.endswith("shared")) == lanes


def test_mid_ip_sidecar_resume_equivalent(runs):
    """Cut after ``CUT`` iterates and resumed by ``run_config`` from the
    checkpoint and sidecar: a partial roll-back, then the same image set as
    an uninterrupted run, which holds every path of the survey (as
    tests/test_bench_resume.py's uninterrupted run does), each image once."""
    side, p = _rolled_back(runs["dirs"]["cut"])
    # the roll-back: the loaded batch, and the linked one with the nodes its
    # edges reach, pruned and queued again, sorted, ahead of the unconsumed
    # queue; the relaxed nodes no edge of theirs reaches kept
    requeue = sorted(set(side["pending"]) | set(side["linked"]))
    kept = _graph_paths(p)
    assert len(side["pending"]) == BATCH and len(side["linked"]) > BATCH and side["remaining"]
    assert p._add_queue == requeue + side["remaining"]
    assert kept == sorted(set(runs["paths"]) - set(requeue) - set(side["remaining"]))
    assert 0 < len(kept) < runs["cut"]["nodes"]
    r = runs["resumed"]
    assert r["resumed_at"] == PipelineState.INITIAL_PROCESSING and r["resume_kept_nodes"] == len(kept)
    assert r["n_nodes"] == r["n_survey_paths_in_graph"] == N_IMAGES
    done = _load(runs["dirs"]["resume"])  # saved at the transition out of INITIAL_PROCESSING
    assert done.get_state() == PipelineState.MESH_REFINEMENT
    assert _graph_paths(done) == sorted(runs["paths"])


def test_stale_sidecar_ignored(runs):
    p = _load(runs["dirs"]["stale"])
    before = _graph_paths(p)
    TB._resume_mid_ip(p, runs["dirs"]["stale"])
    assert _graph_paths(p) == before and p._add_queue == []


def test_corrupt_sidecar_survives(runs, tmp_path):
    ckpt = str(tmp_path / "corrupt")
    shutil.copytree(runs["dirs"]["cut"], ckpt)
    with open(os.path.join(ckpt, "ip_sidecar.json"), "w") as f:
        f.write('{"remaining": [truncated')  # cut while writing
    p = _load(ckpt)
    before = _graph_paths(p)
    TB._resume_mid_ip(p, ckpt)  # must not raise
    assert _graph_paths(p) == before and p._add_queue == []


def test_jax_resume_from_port_sidecar_matches_port(runs):
    ckpt = runs["dirs"]["cut"]
    _, port = _rolled_back(ckpt)
    ref = JPipeline(batch_size=BATCH, parallelism=2)
    assert ref.load_checkpoint(ckpt)
    JB._resume_mid_ip(ref, ckpt)
    assert ref._add_queue == port._add_queue and 0 < len(port._add_queue) < N_IMAGES
    assert _graph_paths(ref) == _graph_paths(port) and _graph_paths(port)


def test_jax_sidecar_writer_writes_the_port_json(runs, tmp_path):
    ckpt = runs["dirs"]["cut"]
    ref = JPipeline(batch_size=BATCH, parallelism=2)
    assert ref.load_checkpoint(ckpt)
    cut = runs["cut"]
    ref._add_queue, ref._prev_loaded_ids, ref._prev_linked_ids = cut["queue"], cut["loaded"], cut["linked"]
    JB._save_ip_sidecar(ref, str(tmp_path))
    got = open(os.path.join(ckpt, "ip_sidecar.json")).read()
    assert open(tmp_path / "ip_sidecar.json").read() == got
    side = json.loads(got)
    assert len(side["pending"]) == BATCH < len(side["linked"]) and side["remaining"]
    assert side["state"] == "INITIAL_PROCESSING"


def test_bench_survey_matches_the_jax_fixture(tmp_path):
    (tmp_path / "jax").mkdir()
    saved = TB.SURVEY_ROOT
    TB.SURVEY_ROOT = str(tmp_path / "port")
    try:
        paths, positions, quats, _ = TB.bench_survey(SURVEY_IMAGES, device="cpu")
    finally:
        TB.SURVEY_ROOT = saved
    j_paths, j_positions, j_quats = JS.write_survey(str(tmp_path / "jax"), rows=2, cols=3)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in j_paths]
    np.testing.assert_allclose(positions, j_positions, rtol=0, atol=0)
    np.testing.assert_allclose(quats, np.asarray(j_quats), rtol=0, atol=1e-12)
    close = total = 0
    for a, b in zip(paths, j_paths):
        sa = json.load(open(os.path.splitext(a)[0] + ".json"))
        sb = json.load(open(os.path.splitext(b)[0] + ".json"))
        assert sa.keys() == sb.keys()
        for k, v in sb.items():
            if isinstance(v, float):
                assert abs(sa[k] - v) <= SIDECAR_REL * max(1.0, abs(v)), k
            else:
                assert sa[k] == v, k
        got, want = decode_jpeg(open(a, "rb").read()), decode_jpeg(open(b, "rb").read())
        assert got.shape == want.shape == (TS.IMG_H, TS.IMG_W)
        close += int(np.sum(np.abs(got.astype(int) - want.astype(int)) <= PIXEL_LEVELS))
        total += got.size
    assert close / total >= PIXEL_SHARE, close / total
    # the encoder at the bench survey's quality, on a rendered image
    gray = decode_jpeg(open(paths[0], "rb").read())
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, TS.BENCH_JPEG_QUALITY])
    assert ok and encode_jpeg(gray, TS.BENCH_JPEG_QUALITY) == buf.tobytes()


def test_build_workload_matches_bench_py():
    images, positions, pa, pb = TBENCH.build_workload(device="cpu")
    j_images, j_positions, j_pa, j_pb = JBENCH.build_workload()
    np.testing.assert_array_equal(positions, j_positions)
    np.testing.assert_array_equal(pa, j_pa)
    np.testing.assert_array_equal(pb, j_pb)
    assert len(pa) == 42 and images.shape == (24, TS.IMG_H, TS.IMG_W)
    np.testing.assert_allclose(images, np.asarray(j_images), rtol=0, atol=WORKLOAD_ATOL)


def test_twins_without_jax_cv2_or_pil(tmp_path):
    """In a process where ``import jax``, ``import opencalibration_tpu``,
    ``import cv2`` and ``import PIL`` fail, the three twins import and the
    bench survey is written."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "opencalibration_tpu", "cv2", "PIL"):
            sys.modules[name] = None  # any import of it raises
        from opencalibration_tpu_torch.bench import bench, bench_e2e, bench_scale
        bench_e2e.SURVEY_ROOT = {str(tmp_path)!r}
        paths = bench_e2e.bench_survey(4, device="cpu")[0]
        again = bench_e2e.bench_survey(4, device="cpu")[0]
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu", "cv2", "PIL") and sys.modules[m])
        print(len(paths), paths == again, loaded)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one torch thread, as in this process
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["4", "True", "[]"]
    assert sorted(os.listdir(os.path.join(str(tmp_path), "torch_2x2")))[:2] == ["IMG_0000.jpg", "IMG_0000.json"]
