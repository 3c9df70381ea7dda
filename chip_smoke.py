"""Smoke run of the PyTorch + CUDA port (``opencalibration_tpu_torch``) on one
NVIDIA GPU.

Phases, each printing its lines:

1. device: the card's name, count and power limit;
2. build: ``csrc/hamming_top2.cu`` compiled by nvcc from this checkout;
3. the Hamming top-2 kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shape [42, 2048, 2048] and on edge cases,
   then both timed with CUDA events;
4. ``calibration_step`` on CUDA against the same call on the CPU, on a
   2 x 3 survey at 320 x 240;
5. ``calibration_step`` at full size: 24 images at 1600 x 1200, 2048
   features, 42 pairs, 2048 RANSAC hypotheses, 50 LM iterations; step and
   stage times, peak memory, kernel launches, rotation error against the
   scene's ground truth;
6. the pipeline's INITIAL_PROCESSING on CUDA against the same run on the
   CPU, on a 2 x 3 PGM survey at 320 x 240 with ``batch_size=3``: equal
   nodes and edges, orientations within 0.1 degrees, the Hamming kernel
   launched and bit-exact on the link's own descriptors;
7. INITIAL_PROCESSING at full size with the pipeline's defaults: 24 PGM
   images at 1600 x 1200 in batches of 10; seconds per ``iterate_once``, the
   stage counters, nodes / edges / groups, LM iterations, peak memory, kernel
   launches, the kernel against its plain version on one link chunk, and the
   orientation error against the scene's ground truth;
8. the same 24-image survey rendered over terrain with 8 m of sinusoidal
   relief (70 m wavelength), driven from INITIAL_PROCESSING through
   MESH_REFINEMENT, INITIAL_GLOBAL_RELAX (skipped by default),
   CAMERA_PARAMETER_RELAX (skipped) and FINAL_GLOBAL_RELAX to
   GENERATE_THUMBNAIL: seconds per ``iterate_once`` and per state, mesh
   vertices and triangles and the grid level after every pass, every
   solve's tangent dimension and route, LM iterations, plan reuses, peak
   memory, the stage counters, the orientation error after
   INITIAL_PROCESSING (printed; the ground-plane relax cannot follow the
   relief) and at the end (bounded), and the final mesh's height error
   against the relief; then the last full problem solved with the dense and
   the matrix-free linear solvers on the card (their difference and time per
   LM iteration), and the matrix-free solve run twice, bit for bit.

The ``kernels`` line gives each kernel's launches on the main path, phase 8
(INITIAL_PROCESSING through FINAL_GLOBAL_RELAX), and on the paths of
phases 7 and 5, each taken with the counter set to 0 just before the path
and read just after it. Run from the repository root with
``python3 chip_smoke.py``. Any
failed check raises, so the exit code is non-zero; without a CUDA device it
exits with 1 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.ops import ransac as R
from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
from opencalibration_tpu_torch.parallel import group_solver as GS
from opencalibration_tpu_torch.pipeline import calibration as C
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.relax import lm as LM
from opencalibration_tpu_torch.testing import survey as S
from opencalibration_tpu_torch.utils import performance

SMALL = dict(rows=2, cols=3, width=320, height=240, focal=400.0, texture=512,
             max_features=1024)
# the bench scene at the reference's extraction size (<= 1600 px): image,
# focal and texture scaled x5 together keep the footprint and overlap
FULL = dict(rows=4, cols=6, width=1600, height=1200, focal=2000.0, texture=2560,
            max_features=2048)
SPACING = 12.0
NUM_HYPOTHESES = 2048
MAX_ITERATIONS = 50
# CUDA vs CPU run of the port: the bound the CPU parity test holds the port
# to against the JAX package (tests/test_torch_calibration.py)
PARITY_DEG = 0.1
# against ground truth at full size
MEDIAN_DEG, MAX_DEG = 2.0, 5.0
# the pipeline's terrain: amplitude and wavelength of the sinusoidal relief
RELIEF_M, RELIEF_WAVELENGTH_M = 8.0, 70.0
# final mesh heights against the relief, at the vertices inside the camera
# footprint (the mesh is a coarse piecewise-linear fit of an 8 m sinusoid)
HEIGHT_MEDIAN_M, HEIGHT_MAX_M = 1.0, 4.0
# the matrix-free step against the dense one on the last full problem: the CG
# step is inexact (rtol 1e-2), so the two solves take different paths
CG_VS_CHOLESKY_DEG, CG_VS_CHOLESKY_M = 0.05, 0.1
KERNEL_SOURCE = "opencalibration_tpu_torch/csrc/hamming_top2.cu"
KERNEL_REPLACES = "opencalibration_tpu/ops/hamming_pallas.py:43"


def _sync():
    torch.cuda.synchronize()


def _angles_deg(q_a, q_b):
    q_a = torch.as_tensor(q_a, dtype=torch.float64).cpu()
    q_b = torch.as_tensor(q_b, dtype=torch.float64).cpu()
    return np.degrees(quat_angle(quat_multiply(q_a, quat_conjugate(q_b))).numpy())


def _scene(cfg, device):
    positions, quats = S.camera_grid(cfg["rows"], cfg["cols"], spacing=SPACING)
    pa, pb = S.knn_pairs(positions)
    tex = S.make_texture(0, size=cfg["texture"])
    images = S.render_views(tex, positions, quats, width=cfg["width"], height=cfg["height"],
                            focal=cfg["focal"], device=device)
    return images, positions, quats, pa, pb


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}, {count} device(s); python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, count, smi


def phase_build():
    info = hamming_cuda.build()
    print(f"[build] {info.seconds:.2f} s -> {info.library}")
    for line in info.ptxas.splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def _random_words(rng, shape, garbage_padding=False):
    """Packed descriptors as int32 bit patterns; with garbage_padding the 26
    bits above the 486 real ones are random too."""
    words = rng.integers(0, 2**32, size=shape + (16,), dtype=np.uint64).astype(np.uint32)
    if not garbage_padding:
        words[..., 15] &= np.uint32((1 << 6) - 1)
    return torch.from_numpy(words.view(np.int32))


def _flip_bits(rng, words, rate):
    """Copies of packed words with each of the 512 bits flipped at ``rate``."""
    flips = rng.random(words.shape + (32,)) < rate
    mask = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64), axis=-1)
    return torch.from_numpy((words.numpy().view(np.uint32) ^ mask.astype(np.uint32)).view(np.int32))


def _kernel_cases(rng):
    """(name, packed1, packed2, valid1, valid2) on the CPU."""
    def bits(n):
        return torch.from_numpy(rng.integers(0, 2, size=(n, H.DESCRIPTOR_BITS)).astype(bool))

    def ones(n):
        return torch.ones(n, dtype=torch.bool)

    cases = []
    b1, b2 = bits(200), bits(300)
    cases.append(("agreement 200x300", H.pack_bits(b1), H.pack_bits(b2), ones(200), ones(300)))
    b1 = bits(64)
    b2 = torch.cat([b1, bits(64)])
    v2 = torch.tensor([False] * 64 + [True] * 64)
    cases.append(("validity 64+64", H.pack_bits(b1), H.pack_bits(b2), ones(64), v2))
    cases.append(("non-aligned 130x257", H.pack_bits(bits(130)), H.pack_bits(bits(257)),
                  ones(130), ones(257)))
    # every row of set 1 appears twice in set 2: a tie for best at distance 0
    p1 = _random_words(rng, (96,))
    p2 = torch.cat([_flip_bits(rng, p1[:48], 0.02), p1, p1])
    cases.append(("forced ties", p1, p2, ones(96), ones(p2.shape[0])))
    p1, p2 = _random_words(rng, (70,)), _random_words(rng, (90,))
    cases.append(("no valid column", p1, p2, ones(70), torch.zeros(90, dtype=torch.bool)))
    v2 = torch.zeros(90, dtype=torch.bool)
    v2[37] = True
    cases.append(("one valid column", p1, p2, ones(70), v2))
    p1 = _random_words(rng, (150,), garbage_padding=True)
    p2 = torch.cat([_flip_bits(rng, p1, 0.05), _random_words(rng, (100,), garbage_padding=True)])
    cases.append(("garbage padding bits", p1, p2, ones(150), ones(250)))
    return cases


def _main_path_case(rng, pairs, n):
    """[pairs, n, 16] descriptors where 3/4 of set 2 are noisy copies of set 1
    in shuffled order, with some invalid rows on both sides."""
    p1 = _random_words(rng, (pairs, n))
    p2 = _random_words(rng, (pairs, n))
    m = 3 * n // 4
    for k in range(pairs):
        perm = torch.from_numpy(rng.permutation(n)[:m])
        p2[k, perm] = _flip_bits(rng, p1[k, :m], 0.08)
    v1 = torch.from_numpy(rng.random((pairs, n)) < 0.97)
    v2 = torch.from_numpy(rng.random((pairs, n)) < 0.97)
    return p1, p2, v1, v2


def _cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _timed(p1, p2, v1, v2, label):
    """match_descriptors through the kernel and through the plain version, 20
    launches each, in the order plain, kernel, kernel, plain."""
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = H.match_descriptors if which == "kernel" else H.match_descriptors_reference
        runs[which].append(_cuda_ms(lambda: fn(p1, p2, v1, v2), 20))
    print(f"[kernel] match_descriptors at {label}: kernel {runs['kernel']} ms, "
          f"plain {runs['plain']} ms (CUDA events, 20 launches each, plain/kernel/kernel/plain)")
    return statistics.mean(runs["kernel"]), statistics.mean(runs["plain"])


def phase_kernel():
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    calib = ("calibration step [42, 2048, 2048]",) + _main_path_case(rng, 42, 2048)
    link = ("pipeline link chunk [16, 1024, 1024]",) + _main_path_case(rng, ST.LINK_CHUNK, ST.LINK_SUBSET)
    max_err = 0.0
    for name, p1, p2, v1, v2 in _kernel_cases(rng) + [calib, link]:
        p1, p2, v1, v2 = (t.to(dev).contiguous() for t in (p1, p2, v1, v2))
        top2 = hamming_cuda.hamming_top2(p1, p2, v2)
        top2_ref = H.hamming_top2_reference(p1, p2, v2)
        got = H.match_descriptors(p1, p2, v1, v2)
        want = H.match_descriptors_reference(p1, p2, v1, v2)
        _sync()
        for label, g, w in zip(("best", "second", "idx", "idx2", "distance", "matched"),
                               top2 + got, top2_ref + want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
                bad = int((g != w).sum()) if g.shape == w.shape else -1
                raise AssertionError(f"kernel != plain version on {name}: {label}, {bad} entries differ")
        err = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
        max_err = max(max_err, err)
        print(f"[kernel] {name}: bit-exact ({int(got[2].sum())} of {got[2].numel()} rows matched)")

    ms, plain_ms = _timed(*(t.to(dev).contiguous() for t in calib[1:]), "[42, 2048, 2048]")
    ms_link, plain_ms_link = _timed(*(t.to(dev).contiguous() for t in link[1:]), "[16, 1024, 1024]")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, ms_link=ms_link, plain_ms_link=plain_ms_link)


def phase_cuda_vs_cpu():
    images, positions, _, pa, pb = _scene(SMALL, "cpu")
    args = (torch.tensor(positions, dtype=torch.float32), torch.tensor(pa), torch.tensor(pb))
    kw = dict(focal=SMALL["focal"], max_features=SMALL["max_features"],
              num_hypotheses=NUM_HYPOTHESES, max_iterations=MAX_ITERATIONS)
    q_cpu = C.calibration_step(images, *args, **kw)
    q_gpu = C.calibration_step(images.cuda(), *(a.cuda() for a in args), **kw)
    _sync()
    if q_gpu.shape != q_cpu.shape or not torch.isfinite(q_gpu).all():
        raise AssertionError(f"CUDA result malformed: {tuple(q_gpu.shape)}")
    diff = _angles_deg(q_gpu, q_cpu)
    print(f"[cuda-vs-cpu] 2x3 at 320x240: max {diff.max():.5f} deg between the CUDA and CPU "
          f"runs (bound {PARITY_DEG}); per camera {np.round(diff, 5).tolist()}")
    if diff.max() > PARITY_DEG:
        raise AssertionError(f"CUDA and CPU runs differ by {diff.max():.4f} deg")


def phase_full_size():
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    images, positions, quats_gt, pa, pb = _scene(FULL, dev)
    _sync()
    n_img, n_pair = images.shape[0], len(pa)
    print(f"[full] scene: {n_img} images {tuple(images.shape[1:])}, {n_pair} pairs, "
          f"rendered in {time.perf_counter() - t0:.2f} s")
    if n_pair != 42 or not torch.isfinite(images).all():
        raise AssertionError("full-size scene is not the 24-image, 42-pair survey")
    pos = torch.tensor(positions, dtype=torch.float32, device=dev)
    pa_t, pb_t = torch.tensor(pa, device=dev), torch.tensor(pb, device=dev)
    kw = dict(focal=FULL["focal"], max_features=FULL["max_features"],
              num_hypotheses=NUM_HYPOTHESES, max_iterations=MAX_ITERATIONS)

    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    t0 = time.perf_counter()
    quats = C.calibration_step(images, pos, pa_t, pb_t, **kw)  # warm-up
    _sync()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        quats = C.calibration_step(images, pos, pa_t, pb_t, **kw)
        _sync()
        times.append(time.perf_counter() - t0)
    launches = hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    if launches == 0:
        raise AssertionError("calibration_step never launched the Hamming kernel")

    # per-stage breakdown of one more step
    stage = {}
    t0 = time.perf_counter()
    feats = F.extract_features(images, max_features=FULL["max_features"])
    _sync()
    stage["extract"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = C._model(FULL["width"], FULL["height"], FULL["focal"], device=dev)
    rel = C._link_all(feats["descriptors"], feats["xy"], feats["valid"], pa_t, pb_t, model,
                      NUM_HYPOTHESES)
    _sync()
    stage["link"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, info = C._relax_all(pos, pa_t, pb_t, *rel, max_iterations=MAX_ITERATIONS)
    _sync()
    stage["relax"] = time.perf_counter() - t0

    # the kernel against its plain version on the step's own descriptors
    d1, d2 = feats["descriptors"][pa_t], feats["descriptors"][pb_t]
    v1, v2 = feats["valid"][pa_t], feats["valid"][pb_t]
    got = H.match_descriptors(d1, d2, v1, v2)
    want = H.match_descriptors_reference(d1, d2, v1, v2)
    _sync()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("kernel != plain version on the full-size step's descriptors")
    print(f"[full] kernel vs plain on the step's descriptors {tuple(d1.shape)}: bit-exact "
          f"({int(got[2].sum())} of {got[2].numel()} rows matched)")

    if quats.shape != (n_img, 4) or not torch.isfinite(quats).all():
        raise AssertionError(f"full-size result malformed: {tuple(quats.shape)}")
    err = _angles_deg(quats, quats_gt)
    n_valid = int(feats["valid"].sum())
    print(f"[full] step: warm-up {warm_s:.3f} s, runs {[round(t, 4) for t in times]} s, "
          f"median {statistics.median(times):.4f} s ({n_img / statistics.median(times):.2f} images/s)")
    print(f"[full] stages: extract {stage['extract']:.4f} s, link {stage['link']:.4f} s, "
          f"relax {stage['relax']:.4f} s ({int(info.iterations)} LM iterations); "
          f"{n_valid} valid keypoints")
    print(f"[full] peak memory allocated {peak / 2**30:.3f} GiB; Hamming kernel launches "
          f"{launches} over {1 + len(times)} steps")
    print(f"[full] rotation error vs ground truth: median {np.median(err):.4f} deg, "
          f"max {err.max():.4f} deg (bounds {MEDIAN_DEG}, {MAX_DEG})")
    if not (np.median(err) <= MEDIAN_DEG and err.max() <= MAX_DEG):
        raise AssertionError(f"cameras not recovered: {np.round(err, 3).tolist()}")
    return launches


class _LinkRecorder:
    """Keeps a copy of the first link chunk's descriptors and validity while
    the pipeline runs (the stage looks its batch function up by name), so the
    kernel can be held against its plain version on them afterwards."""

    def __init__(self):
        self.chunk = None
        self._orig = ST._match_and_ransac_batch

    def __enter__(self):
        def recording(desc1, xy1, valid1, desc2, xy2, valid2, *args, **kw):
            if self.chunk is None:
                self.chunk = tuple(t.clone() for t in (desc1, desc2, valid1, valid2))
            return self._orig(desc1, xy1, valid1, desc2, xy2, valid2, *args, **kw)

        ST._match_and_ransac_batch = recording
        return self

    def __exit__(self, *exc):
        ST._match_and_ransac_batch = self._orig


def _check_link_chunk(chunk, label):
    d1, d2, v1, v2 = chunk
    got = H.match_descriptors(d1, d2, v1, v2)
    want = H.match_descriptors_reference(d1, d2, v1, v2)
    _sync()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"kernel != plain version on the {label} link chunk's descriptors")
    print(f"[{label}] kernel vs plain on a link chunk's own descriptors {tuple(d1.shape)}: bit-exact "
          f"({int(got[2].sum())} of {got[2].numel()} rows matched)")


def _initial_processing(p, paths, timed=False):
    """Drive INITIAL_PROCESSING; with ``timed``, seconds per iterate_once."""
    p.add(paths)
    seconds = []
    while p.get_state() == PipelineState.INITIAL_PROCESSING:
        t0 = time.perf_counter()
        p.iterate_once()
        if timed:
            _sync()
            seconds.append(time.perf_counter() - t0)
    return seconds


def _by_path(p):
    return {n.payload.path: n.payload for _, n in p.graph.nodes()}


def _edge_paths(p):
    return {(p.graph.get_node(e.source).payload.path, p.graph.get_node(e.dest).payload.path)
            for _, e in p.graph.edges()}


def phase_pipeline_cuda_vs_cpu():
    uniforms = R.default_uniforms(ST.LINK_HYPOTHESES, 4, R.DEFAULT_SEED, "cpu")
    with tempfile.TemporaryDirectory() as d:
        paths, _, _ = S.write_survey(d, 2, 3, device="cpu")
        cpu = Pipeline(batch_size=3, device="cpu", ransac_uniforms=uniforms)
        _initial_processing(cpu, paths)
        gpu = Pipeline(batch_size=3, device="cuda", ransac_uniforms=uniforms)
        hamming_cuda.hamming_top2.launches = 0
        with _LinkRecorder() as rec:
            _initial_processing(gpu, paths)
        _sync()
        launches = hamming_cuda.hamming_top2.launches
    a, b = _by_path(gpu), _by_path(cpu)
    if a.keys() != b.keys() or len(a) != 6:
        raise AssertionError(f"CUDA and CPU pipelines hold different nodes: {len(a)} vs {len(b)}")
    if _edge_paths(gpu) != _edge_paths(cpu):
        raise AssertionError("CUDA and CPU pipelines hold different edges")
    diff = np.asarray([_angles_deg(a[k].orientation, b[k].orientation) for k in sorted(a)])
    print(f"[pipeline-cuda-vs-cpu] 2x3 at 320x240: {len(a)} nodes, {gpu.graph.size_edges()} edges on both; "
          f"orientations max {diff.max():.5f} deg apart (bound {PARITY_DEG}); Hamming kernel launches {launches}")
    if not np.isfinite(diff).all() or diff.max() > PARITY_DEG:
        raise AssertionError(f"CUDA and CPU pipelines differ by {diff.max():.4f} deg")
    if launches == 0:
        raise AssertionError("the CUDA pipeline never launched the Hamming kernel")
    _check_link_chunk(rec.chunk, "pipeline-cuda-vs-cpu")
    return launches


def phase_pipeline_full_size(directory, relief_m, label):
    """INITIAL_PROCESSING at full size over terrain with ``relief_m`` of
    relief. Returns the pipeline, the survey's paths, positions and
    orientations, and the state's kernel launches."""
    cfg = FULL
    t0 = time.perf_counter()
    paths, positions, quats_gt = S.write_survey(
        directory, cfg["rows"], cfg["cols"], spacing=SPACING, width=cfg["width"], height=cfg["height"],
        focal=cfg["focal"], texture=cfg["texture"], relief_amplitude=relief_m,
        relief_wavelength=RELIEF_WAVELENGTH_M, device="cuda",
    )
    print(f"[{label}] wrote {len(paths)} PGM images at {cfg['width']}x{cfg['height']} "
          f"(relief {relief_m} m) in {time.perf_counter() - t0:.2f} s")
    p = Pipeline(device="cuda")  # the pipeline's defaults: batches of 10
    groups = []
    solve_groups = ST.solve_groups

    def counting(builts, *args, **kw):
        groups.append(len(builts))
        return solve_groups(builts, *args, **kw)

    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    ST.solve_groups = counting
    hamming_cuda.hamming_top2.launches = 0
    try:
        with _LinkRecorder() as rec:
            seconds = _initial_processing(p, paths, timed=True)
    finally:
        ST.solve_groups = solve_groups
        performance.enable_performance_counters(False)
    launches = hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] INITIAL_PROCESSING: {len(seconds)} iterate_once calls, seconds "
          f"{[round(t, 4) for t in seconds]}, total {sum(seconds):.4f} s")
    print(f"[{label}] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[{label}]   {line}")
    nodes = _by_path(p)
    degree = {path: 0 for path in nodes}
    for a, b in _edge_paths(p):
        degree[a] += 1
        degree[b] += 1
    lm_iters = int(performance.get_event_count("lm iterations"))
    print(f"[{label}] {len(nodes)} nodes, {p.graph.size_edges()} edges, relax groups per solve {groups}, "
          f"{lm_iters} LM iterations (full solves), peak memory allocated {peak / 2**30:.3f} GiB, "
          f"Hamming kernel launches {launches}")
    if len(nodes) != len(paths) or min(degree.values()) < 1:
        raise AssertionError(f"not every image is linked: {len(nodes)} nodes, degrees {sorted(degree.values())}")
    if launches == 0:
        raise AssertionError("the pipeline never launched the Hamming kernel")
    _check_link_chunk(rec.chunk, label)
    return p, paths, positions, quats_gt, launches


def _orientation_error(p, paths, quats_gt, label, bounded=True):
    """Orientation error against the ground truth; with ``bounded``, raise
    outside the bounds."""
    nodes = _by_path(p)
    err = np.asarray([_angles_deg(nodes[path].orientation, quats_gt[i]) for i, path in enumerate(paths)])
    bounds = f"bounds {MEDIAN_DEG}, {MAX_DEG}" if bounded else "not bounded"
    print(f"[{label}] orientation error vs ground truth: median {np.median(err):.4f} deg, "
          f"max {err.max():.4f} deg ({bounds})")
    if not np.isfinite(err).all():
        raise AssertionError(f"non-finite orientations: {err.tolist()}")
    if bounded and not (np.median(err) <= MEDIAN_DEG and err.max() <= MAX_DEG):
        raise AssertionError(f"cameras not recovered: {np.round(err, 3).tolist()}")


class _SolveRecorder:
    """Records every relax solve of the pipeline (groups, each group's
    tangent dimension, the batch layout's dimension and route, LM
    iterations) and keeps the last one's built problems."""

    def __init__(self):
        self.solves = []
        self.last_builts = None
        self._orig = ST.solve_groups

    def __enter__(self):
        def recording(builts, *args, **kw):
            dim = GS.batch_layout(builts).dim
            out = self._orig(builts, *args, **kw)
            self.solves.append(dict(
                groups=len(builts), dims=[b.layout.dim for b in builts], batch_dim=dim,
                route=LM.route(dim), lm=[int(i.iterations) for i in out[1]],
            ))
            self.last_builts = list(builts)
            return out

        ST.solve_groups = recording
        return self

    def __exit__(self, *exc):
        ST.solve_groups = self._orig


def _height_error(p, positions):
    """Final mesh heights against the relief at the vertices inside the
    camera footprint, in the survey's frame (local frame + the first
    camera's offset)."""
    first = _by_path(p)[sorted(_by_path(p))[0]]
    offset = positions[0] - np.asarray(first.position)
    v = p.surfaces[0].mesh.vertices + offset
    lo, hi = positions[:, :2].min(0), positions[:, :2].max(0)
    inside = np.all((v[:, :2] >= lo) & (v[:, :2] <= hi), axis=1)
    truth = S.relief_height(torch.as_tensor(v[inside, :2]), RELIEF_M, RELIEF_WAVELENGTH_M).numpy()
    return np.abs(v[inside, 2] - truth), int(inside.sum())


def _solve_ms_per_iteration(built, linear_solver):
    _sync()
    t0 = time.perf_counter()
    params, info = LM.solve(built.params, built.blocks, built.layout, built.free_mask, linear_solver=linear_solver)
    _sync()
    seconds = time.perf_counter() - t0
    return params, info, 1e3 * seconds / max(int(info.iterations), 1)


def phase_mesh_refinement(directory):
    """The relief survey from INITIAL_PROCESSING through FINAL_GLOBAL_RELAX;
    returns the kernel launches of the whole run (the link check between the
    two parts launches the kernel too and is not counted)."""
    p, paths, positions, quats_gt, ip_launches = phase_pipeline_full_size(directory, RELIEF_M, "mesh-ip")
    _orientation_error(p, paths, quats_gt, "mesh-ip", bounded=False)
    p.skip_camera_param_relax = True
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps = []
    try:
        with _SolveRecorder() as rec:
            while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
                state = p.get_state()
                n_solves = len(rec.solves)
                t0 = time.perf_counter()
                p.iterate_once()
                _sync()
                mesh = p.surfaces[0].mesh if p.surfaces else None
                steps.append(dict(
                    state=state, seconds=time.perf_counter() - t0,
                    level=getattr(p, "_mesh_grid_level", None) if state == PipelineState.MESH_REFINEMENT else None,
                    vertices=mesh.num_vertices if mesh is not None else 0,
                    triangles=mesh.num_triangles if mesh is not None else 0,
                    solves=rec.solves[n_solves:],
                ))
                if len(steps) > 60:
                    raise AssertionError("the pipeline did not reach GENERATE_THUMBNAIL in 60 passes")
    finally:
        performance.enable_performance_counters(False)
    launches = ip_launches + hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    per_state = {}
    for st in steps:
        per_state.setdefault(st["state"], []).append(st["seconds"])
    print(f"[mesh] {len(steps)} iterate_once calls, total {sum(st['seconds'] for st in steps):.4f} s; per state "
          + ", ".join(f"{k} {len(v)} x, {sum(v):.4f} s" for k, v in per_state.items()))
    for i, st in enumerate(steps):
        solves = "; ".join(
            f"{s['groups']} group(s) dims {s['dims']} batch dim {s['batch_dim']} -> {s['route']}, LM {s['lm']}"
            for s in st["solves"]
        ) or "no solve"
        print(f"[mesh] pass {i}: {st['state']} level {st['level']}, {st['seconds']:.4f} s, "
              f"{st['vertices']} vertices, {st['triangles']} triangles; {solves}")
    print("[mesh] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[mesh]   {line}")
    refine_passes = per_state.get(PipelineState.MESH_REFINEMENT, [])
    reuses = int(performance.get_event_count("relax plan reuses"))
    lm_iters = int(performance.get_event_count("lm iterations"))
    routes = sorted({s["route"] for st in steps for s in st["solves"]})
    print(f"[mesh] {len(refine_passes)} MESH_REFINEMENT passes, final mesh {steps[-1]['vertices']} vertices / "
          f"{steps[-1]['triangles']} triangles, {lm_iters} LM iterations (full solves), {reuses} plan reuses, "
          f"routes {routes}, peak memory allocated {peak / 2**30:.3f} GiB; Hamming kernel launches {launches} "
          f"from INITIAL_PROCESSING on")
    if len(refine_passes) < 2 or steps[-1]["triangles"] <= 2:
        raise AssertionError("MESH_REFINEMENT never refined the mesh over the relief")
    if reuses == 0:
        raise AssertionError("FINAL_GLOBAL_RELAX never reused its plan")
    _orientation_error(p, paths, quats_gt, "mesh")
    herr, n_inside = _height_error(p, positions)
    print(f"[mesh] mesh height error vs the relief at {n_inside} vertices inside the camera footprint: "
          f"median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if not n_inside or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        raise AssertionError(f"mesh does not follow the relief: {np.round(herr, 3).tolist()}")

    # the last full problem (FINAL_GLOBAL_RELAX's one-group pass), solved by
    # the dense and the matrix-free linear solvers on the card
    built = rec.last_builts[-1]
    torch.cuda.reset_peak_memory_stats()
    ch, ch_info, ch_ms = _solve_ms_per_iteration(built, "cholesky")
    ch_peak = torch.cuda.max_memory_allocated()
    cg, cg_info, cg_ms = _solve_ms_per_iteration(built, "cg")
    cg2, _, cg2_ms = _solve_ms_per_iteration(built, "cg")
    ang = _angles_deg(ch.quats, cg.quats)
    dz = float((ch.mesh_z - cg.mesh_z).abs().max())
    same = all(torch.equal(getattr(cg, f), getattr(cg2, f)) for f in ("quats", "mesh_z", "focal", "radial"))
    print(f"[mesh] last full problem: tangent dim {built.layout.dim} ({built.layout.C} cameras, "
          f"{built.layout.V} mesh slots), blocks {[(b.name, b.slots.shape[0]) for b in built.blocks]}")
    print(f"[mesh] cholesky: {int(ch_info.iterations)} LM iterations, {ch_ms:.3f} ms each, peak memory allocated "
          f"{ch_peak / 2**30:.3f} GiB; cg: {int(cg_info.iterations)} LM iterations, {cg_ms:.3f} / {cg2_ms:.3f} ms "
          f"each (two runs); cg vs cholesky: orientations {ang.max():.5f} deg, heights {dz:.5f} m apart "
          f"(bounds {CG_VS_CHOLESKY_DEG}, {CG_VS_CHOLESKY_M}); cg run twice bit-identical: {same}")
    if not same:
        raise AssertionError("two CG solves of the same problem differ")
    if not (np.isfinite(ang).all() and ang.max() <= CG_VS_CHOLESKY_DEG and dz <= CG_VS_CHOLESKY_M):
        raise AssertionError("the CG and Cholesky solves disagree")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    name, count, _ = phase_device()
    phase_build()
    kernel = phase_kernel()
    phase_cuda_vs_cpu()
    step_launches = phase_full_size()
    phase_pipeline_cuda_vs_cpu()
    with tempfile.TemporaryDirectory() as d:
        p, paths, _, quats_gt, ip_launches = phase_pipeline_full_size(d, 0.0, "pipeline")
        _orientation_error(p, paths, quats_gt, "pipeline")
    del p
    with tempfile.TemporaryDirectory() as d:
        mesh_launches = phase_mesh_refinement(d)
    print(json.dumps({"kernels": [dict(
        name="hamming_top2", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL_REPLACES,
        launches=mesh_launches,
        paths={"pipeline INITIAL_PROCESSING..FINAL_GLOBAL_RELAX, relief": mesh_launches,
               "pipeline INITIAL_PROCESSING, flat": ip_launches, "calibration_step": step_launches},
        **kernel,
    )]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
