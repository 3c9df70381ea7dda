"""Smoke run of the PyTorch + CUDA port (``opencalibration_tpu_torch``) on one
NVIDIA GPU.

Phases, each printing its lines:

1. device: the card's name, count and power limit, and that no module of
   JAX or of the JAX package ``opencalibration_tpu`` is loaded (checked
   again at the end);
2. build: ``csrc/hamming_top2.cu`` compiled by nvcc from this checkout, the
   compile time, ptxas's registers, shared memory and spills, and the
   warpgroup MMA instructions in its SASS (where the toolkit has
   ``cuobjdump``);
3. the Hamming top-2 kernel against its plain PyTorch version on the card,
   bit for bit and twice, on the contract's edge cases, on a set 2 split over
   a cluster with ties across splits, and at the main path's shapes
   [42, 2048, 2048] and [16, 1024, 1024]; then at both shapes the kernel,
   ``match_descriptors``, the plain version and ``torch._int_mm`` (the +-1
   product alone, the library yardstick) timed with CUDA events, beside the
   kernel's bound;
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
8. a 9-image survey (3 x 3 at 320 x 240; the full image size over this
   relief is phase 9's) rendered over terrain with
   8 m of sinusoidal relief (70 m wavelength), driven from
   INITIAL_PROCESSING through
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
   LM iteration), and the matrix-free solve run twice, bit for bit;
9. the whole pipeline at full size, the main path: the 24-image survey over
   the same relief, written in colour (binary PPM) with a seeded +-10 %
   exposure gain per image, its geotags' focal length 5 % above the true
   2000 px, from
   ``add(paths)`` with the pipeline's defaults through INITIAL_PROCESSING,
   MESH_REFINEMENT, CAMERA_PARAMETER_RELAX with the intrinsics free, the
   edge refit and FINAL_GLOBAL_RELAX to GENERATE_THUMBNAIL: seconds, passes,
   LM iterations, problem builds and refreshes per state; per pass of
   CAMERA_PARAMETER_RELAX the option tier, the camera model, and the model
   inversion, model conversion and refit scopes; the focal error against
   the truth (bounded at 3 %, and below the tag's 5 %), orientations and
   mesh heights (bounded as in phase 8), a finite homography on every edge
   that kept inliers, one build and five refreshes in the state, one refit;
   then ``save_checkpoint``, ``load_checkpoint`` into a fresh pipeline, and
   the two compared; then the same pipeline carries on through
   GENERATE_THUMBNAIL, GENERATE_LAYERS, COLOR_BALANCE and BLEND_LAYERS to
   COMPLETE with the reference's defaults (64 MP cap, tiles of 256, 3 x 3
   taps, four blend levels) and every output path set: seconds per state,
   the mosaic's size, GSD and tiles, the ``ortho: ...`` scope counters, the
   correspondences, the balance's cost, image-cache hits and misses, device
   uploads, peak memory. Checked: a Lab thumbnail of 58 x 43 on every node;
   the three GeoTIFFs read back with their sizes, georeference and
   overviews; coverage inside the camera footprint; the camera-id raster
   (node ids only, 0 exactly where nothing is covered, each camera or a grid
   neighbour under its own nadir); the DSM against the relief; the
   orthomosaic's L against the scene's own texture resampled at its
   georeference (the error averaged over 3 m boxes, which takes out the few
   pixels by which calibrated poses miss the scene); a second job at 2 MP blended with and without the colour
   balance (the balance must lower the error: the exposure gains are
   flattened, not kept); ``solve_color_balance`` run twice on the card, bit
   for bit;
10. the shared-intrinsics joint solver on the card against the CPU: the
   state in which phase 8 reached CAMERA_PARAMETER_RELAX (kept aside there;
   the refined mesh, the orientations of MESH_REFINEMENT) is split into
   intrinsics groups of 3 with the focal free, and the
   stacked batch solved by ``solve_group_batch_shared`` in float32 on both
   devices: every group's copy of the shared tail equal bit for bit on
   each device, focal and orientations of the two devices within the
   stated bounds, iterations printed;
11. the ortho tail on the card against the CPU from one ground-truth state
   (a 2 x 3 colour survey at 320 x 240, ``testing/ortho_cases.py``): the
   same correspondences, balance parameters, RGBA bytes and camera ids
   within the stated tolerances.

The ``kernels`` line gives each kernel's launches on the main path, phase 9
(INITIAL_PROCESSING through the camera parameters and the ortho tail to
COMPLETE),
and on the paths of phases 8, 7 and 5, each taken with the counter set to 0
just before the path and read just after it, and phase 3's times and bounds
(``*_link`` at the link's shape). Run from the repository root with
``python3 chip_smoke.py`` (``--phases 2,9`` runs a subset and prints neither
the ``kernels`` nor the ``ok`` line). Any
failed check raises, so the exit code is non-zero; without a CUDA device it
exits with 1 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
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
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.io import geotiff
from opencalibration_tpu_torch.ortho.color_balance import solve_color_balance
from opencalibration_tpu_torch.ortho.ortho import OrthoJob
from opencalibration_tpu_torch.testing import hamming_cases as HC
from opencalibration_tpu_torch.testing import ortho_cases
from opencalibration_tpu_torch.testing import survey as S
from opencalibration_tpu_torch.utils import performance

SMALL = dict(rows=2, cols=3, width=320, height=240, focal=400.0, texture=512,
             max_features=1024)
# the bench scene at the reference's extraction size (<= 1600 px): image,
# focal and texture scaled x5 together keep the footprint and overlap
FULL = dict(rows=4, cols=6, width=1600, height=1200, focal=2000.0, texture=2560,
            max_features=2048)
# phase 8's smaller survey: the same images, half as many
MESH = dict(SMALL, rows=3, cols=3)
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
# camera-parameter relax: the geotags' focal against the true one, and the
# bound on the recovered focal (the JAX package's tests/test_intrinsics_e2e.py)
FOCAL_TAG_FACTOR, FOCAL_REL_BOUND = 1.05, 0.03
# a checkpoint stores mesh vertices with 10 significant digits and cloud
# points with 6 decimals; the graph and the camera models come back exactly
CHECKPOINT_VERTEX_REL, CHECKPOINT_CLOUD_M = 1e-9, 6e-7
# the ortho tail at full size. Covered share of the raster inside the
# bounding box of the camera positions; median absolute L error (levels of
# 255) of the orthomosaic against the scene's own texture inside that box
# plus a margin, the signed error averaged over boxes of ORTHO_SMOOTH_M first:
# the calibrated poses are a few tenths of a degree from the truth, a few
# pixels on the ground, which on this texture (blobs of 0.3 m) costs more
# levels than the exposure does. The +-10 % gains on the gamma-encoded values
# are up to +-13 levels at mid gray. On the 2 x 3 scene at 320 x 240 over the
# same texture, poses 0.2 degrees off, the CPU reads 5.3 with the balance and
# 8.1 without it at 3 m (14 and 15 unsmoothed)
ORTHO_COVERED_SHARE, ORTHO_MEDIAN_L, ORTHO_MARGIN_M, ORTHO_SMOOTH_M = 0.98, 7.0, 15.0, 3.0
GAIN_SPREAD = 0.1
BALANCE_CHECK_MEGAPIXELS = 2.0
THUMBNAIL_HW = (43, 58)  # of a 1600 x 1200 image
# the shared solver in float32, CUDA against CPU, on the 3 x 3 relief survey
SHARED_GROUP_SIZE, SHARED_MAX_ITERATIONS = 3, 50
SHARED_FOCAL_REL, SHARED_DEG = 5e-3, 0.1
KERNEL_SOURCE = "opencalibration_tpu_torch/csrc/hamming_top2.cu"
KERNEL_REPLACES = "opencalibration_tpu/ops/hamming_pallas.py:43"
# NVIDIA's published H100 SXM peaks (dense, at 700 W): int8 tensor cores and
# device memory
H100_INT8_OPS, H100_BYTES_PER_S = 1979e12, 3.35e12


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
    _assert_standalone("device")
    return name, count, smi


def _assert_standalone(label):
    """The port stands alone: no module of JAX or of the JAX package
    (exactly ``opencalibration_tpu``, not the port's prefix) is loaded."""
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu") and sys.modules[m] is not None)
    print(f"[{label}] modules of jax / opencalibration_tpu loaded: {loaded or 'none'}")
    if loaded:
        raise AssertionError(f"the port imported {loaded}")


def phase_build():
    info = hamming_cuda.build()
    print(f"[build] {info.seconds:.2f} s -> {info.library}")
    for line in info.ptxas.splitlines():
        if "ptxas info" in line or "spill" in line or "arning" in line:
            print(f"[build]   {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        print("[build] cuobjdump not found: SASS not shown")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(info.library)], capture_output=True, text=True).stdout
    mma = [line.split(";")[0].split("*/")[-1].strip() for line in sass.splitlines() if "GMMA" in line]
    print(f"[build] SASS: {len(mma)} warpgroup MMA instructions, e.g. {sorted(set(mma))[:2]}")
    if not mma:
        raise AssertionError("the kernel's SASS holds no warpgroup MMA instruction")


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


def _bound(pairs, n1, n2):
    """The least time the card could take for one launch at [pairs, n1, n2]:
    the larger of the int8 operations (a 512-deep multiply-add per distance)
    over the int8 tensor-core peak and the bytes (packed words and valid2 in,
    three int32 results out) over the memory rate. Returns (ms, bound_by)."""
    ops = 2.0 * pairs * n1 * n2 * H.PADDED_BITS
    nbytes = pairs * ((n1 + n2) * 4 * H.DESCRIPTOR_WORDS + n2 + 3 * 4 * n1)
    t_ops, t_bytes = ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _int_mm(p1, p2):
    """One ``torch._int_mm`` per pair on the unpacked +-1 operands (the
    similarity product only, no top-2), or None where it does not run."""
    a = H._unpack_pm1(p1, H.DESCRIPTOR_BITS, torch.int8)
    b = H._unpack_pm1(p2, H.DESCRIPTOR_BITS, torch.int8)
    b_t = [b[k].t() for k in range(b.shape[0])]
    try:
        sim = torch._int_mm(a[0], b_t[0])
    except RuntimeError as e:
        print(f"[kernel] torch._int_mm: not available ({str(e).splitlines()[0]})")
        return None
    best = torch.amin((H.DESCRIPTOR_BITS - sim) >> 1, dim=1)
    plain = torch.amin(H.hamming_matrix(p1[0], p2[0]), dim=1)
    print(f"[kernel] torch._int_mm on pair 0 gives the plain version's distances: {torch.equal(best, plain)}")
    return lambda: [torch._int_mm(a[k], b_t[k]) for k in range(len(b_t))]


def _timed(p1, p2, v1, v2, label, smi):
    """At one shape: the kernel alone, ``match_descriptors`` through it, the
    plain version and the library product, 20 launches each with CUDA events,
    in the order plain, kernel, match, library, library, match, kernel,
    plain. Returns the means and the bound."""
    fns = {
        "plain": lambda: H.match_descriptors_reference(p1, p2, v1, v2),
        "kernel": lambda: hamming_cuda.hamming_top2(p1, p2, v2),
        "match": lambda: H.match_descriptors(p1, p2, v1, v2),
        "library": _int_mm(p1, p2),
    }
    runs = {k: [] for k in fns}
    for which in ("plain", "kernel", "match", "library", "library", "match", "kernel", "plain"):
        if fns[which] is not None:
            runs[which].append(_cuda_ms(fns[which], 20))
    bound_ms, bound_by = _bound(*p1.shape[:2], p2.shape[1])
    ms = statistics.mean(runs["kernel"])
    library_ms = statistics.mean(runs["library"]) if runs["library"] else None
    print(f"[kernel] {label} on {smi}: kernel {runs['kernel']} ms, match_descriptors {runs['match']} ms, "
          f"plain {runs['plain']} ms, torch._int_mm (+-1 product only, no top-2) "
          f"{runs['library'] or 'not available'} ms (CUDA events, 20 launches each)")
    print(f"[kernel] {label}: bound {bound_ms:.6f} ms ({bound_by}); kernel at {100 * bound_ms / ms:.1f} % of it")
    return dict(ms=ms, match_ms=statistics.mean(runs["match"]), plain_ms=statistics.mean(runs["plain"]),
                bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms, library_ms=library_ms)


def phase_kernel(smi):
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    calib = ("calibration step [42, 2048, 2048]",) + HC.main_path_case(rng, 42, 2048)
    link = ("pipeline link chunk [16, 1024, 1024]",) + HC.main_path_case(rng, ST.LINK_CHUNK, ST.LINK_SUBSET)
    split = ("set 2 split over a cluster, ties across splits",) + HC.split_ties_case(rng)
    max_err = 0.0
    for name, p1, p2, v1, v2 in HC.kernel_cases(rng) + [split, calib, link]:
        p1, p2, v1, v2 = (t.to(dev).contiguous() for t in (p1, p2, v1, v2))
        top2 = hamming_cuda.hamming_top2(p1, p2, v2)
        again = hamming_cuda.hamming_top2(p1, p2, v2)
        top2_ref = H.hamming_top2_reference(p1, p2, v2)
        got = H.match_descriptors(p1, p2, v1, v2)
        want = H.match_descriptors_reference(p1, p2, v1, v2)
        _sync()
        for label, g, w in zip(("best", "second", "idx", "idx2", "distance", "matched"),
                               top2 + got, top2_ref + want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
                bad = int((g != w).sum()) if g.shape == w.shape else -1
                raise AssertionError(f"kernel != plain version on {name}: {label}, {bad} entries differ")
        if not all(torch.equal(g, r) for g, r in zip(top2, again)):
            raise AssertionError(f"two launches differ on {name}")
        err = float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0
        max_err = max(max_err, err)
        print(f"[kernel] {name}: bit-exact, twice ({int(got[2].sum())} of {got[2].numel()} rows matched, "
              f"{int((top2[0] == top2[1]).sum())} ties for best)")

    out = _timed(*(t.to(dev).contiguous() for t in calib[1:]), "[42, 2048, 2048]", smi)
    link_out = _timed(*(t.to(dev).contiguous() for t in link[1:]), "[16, 1024, 1024]", smi)
    return dict(max_abs_err=max_err, **out, **{f"{k}_link": v for k, v in link_out.items()})


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


def phase_pipeline_full_size(directory, relief_m, label, cfg=None, focal_px_tag=None, color=False):
    """INITIAL_PROCESSING at full image size (``cfg``, default FULL) over
    terrain with ``relief_m`` of relief, the geotags carrying
    ``focal_px_tag`` (default: the true focal); ``color`` writes PPM files
    with a seeded exposure gain per image. Returns the pipeline, the
    survey's paths, positions and orientations, and the state's kernel
    launches."""
    cfg = cfg or FULL
    t0 = time.perf_counter()
    paths, positions, quats_gt = S.write_survey(
        directory, cfg["rows"], cfg["cols"], spacing=SPACING, width=cfg["width"], height=cfg["height"],
        focal=cfg["focal"], focal_px_tag=focal_px_tag, texture=cfg["texture"], relief_amplitude=relief_m,
        relief_wavelength=RELIEF_WAVELENGTH_M, color=color,
        gains=S.survey_gains(cfg["rows"] * cfg["cols"], spread=GAIN_SPREAD) if color else None, device="cuda",
    )
    kind = "PPM (colour, exposure gains)" if color else "PGM"
    print(f"[{label}] wrote {len(paths)} {kind} images at {cfg['width']}x{cfg['height']} "
          f"(relief {relief_m} m, focal tag {focal_px_tag or cfg['focal']}) in {time.perf_counter() - t0:.2f} s")
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
    two parts launches the kernel too and is not counted) and the state at
    the entry of CAMERA_PARAMETER_RELAX (graph, GPS index, camera models,
    surfaces), which the shared solver's phase starts from."""
    p, paths, positions, quats_gt, ip_launches = phase_pipeline_full_size(directory, RELIEF_M, "mesh-ip", cfg=MESH)
    _orientation_error(p, paths, quats_gt, "mesh-ip", bounded=False)
    p.skip_camera_param_relax = True
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps = []
    entry = None
    try:
        with _SolveRecorder() as rec:
            while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
                state = p.get_state()
                if state == PipelineState.CAMERA_PARAMETER_RELAX and entry is None:
                    entry = (copy.deepcopy(p.graph), p.gps_positions, dict(p.model_store), copy.deepcopy(p.surfaces))
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
    return launches, entry


class _BuildRecorder:
    """Counts the relax stage's problem builds and refreshes (one call per
    group and pass) while the pipeline runs."""

    def __init__(self):
        self.builds = self.refreshes = 0
        self._orig = (ST.build_problem, ST.refresh_problem)

    def __enter__(self):
        build, refresh = self._orig

        def counting_build(*args, **kw):
            self.builds += 1
            return build(*args, **kw)

        def counting_refresh(*args, **kw):
            self.refreshes += 1
            return refresh(*args, **kw)

        ST.build_problem, ST.refresh_problem = counting_build, counting_refresh
        return self

    def __exit__(self, *exc):
        ST.build_problem, ST.refresh_problem = self._orig


CPR_SCOPES = ("relax solve", "relax build problems", "relax refresh problems", "build: model inversion",
              "refresh: model inversion", "writeback: model conversion", "refit all edges")


def _model_line(model):
    return (f"focal {float(model.focal_length_pixels):.4f}, principal {np.round(model.principal_point.numpy(), 4).tolist()}, "
            f"radial {[float(f'{v:.4g}') for v in model.radial_distortion.numpy()]}")


def _assert_same_after_checkpoint(p, q):
    """The loaded pipeline ``q`` against the saved one ``p``: state, graph
    (poses, features, edges), camera models and GPS index exactly; the
    surface within the checkpoint's text formats."""
    if (q.get_state(), q.state_run_count()) != (p.get_state(), p.state_run_count()):
        raise AssertionError(f"checkpoint state {q.get_state()} != {p.get_state()}")
    if q.graph != p.graph:
        raise AssertionError("the loaded graph differs from the saved one")
    if sorted(q.model_store) != sorted(p.model_store):
        raise AssertionError("the loaded camera models differ from the saved ones")
    for mid, m in p.model_store.items():
        for leaf in ("focal_length_pixels", "principal_point", "radial_distortion", "tangential_distortion",
                     "pixels_cols", "pixels_rows"):
            if not torch.equal(getattr(q.model_store[mid], leaf), getattr(m, leaf)) or q.model_store[mid].tag != m.tag:
                raise AssertionError(f"camera model {mid} {leaf} differs after the checkpoint")
    if sorted(q.gps_positions) != sorted(p.gps_positions) or q.geocoord.origin != p.geocoord.origin:
        raise AssertionError("GPS index or origin differs after the checkpoint")
    if len(q.surfaces) != len(p.surfaces):
        raise AssertionError("surface count differs after the checkpoint")
    worst_v = worst_c = 0.0
    for a, b in zip(q.surfaces, p.surfaces):
        if not np.array_equal(a.mesh.triangles, b.mesh.triangles) or len(a.cloud) != len(b.cloud):
            raise AssertionError("surface topology differs after the checkpoint")
        worst_v = max(worst_v, float(np.max(np.abs(a.mesh.vertices - b.mesh.vertices)
                                            / np.maximum(np.abs(b.mesh.vertices), 1.0))))
        for ca, cb in zip(a.cloud, b.cloud):
            if ca.shape != cb.shape:
                raise AssertionError("cloud size differs after the checkpoint")
            worst_c = max(worst_c, float(np.abs(ca - cb).max()))
    if worst_v > CHECKPOINT_VERTEX_REL or worst_c > CHECKPOINT_CLOUD_M:
        raise AssertionError(f"surface differs after the checkpoint: vertices {worst_v}, clouds {worst_c}")
    return worst_v, worst_c


def phase_camera_relax(directory):
    """The whole pipeline at full size, from colour images with a 5 % wrong
    focal tag through a saved and loaded checkpoint to COMPLETE; returns the
    kernel launches from INITIAL_PROCESSING to COMPLETE."""
    true_focal = FULL["focal"]
    p, paths, positions, quats_gt, ip_launches = phase_pipeline_full_size(
        directory, RELIEF_M, "calib-ip", focal_px_tag=FOCAL_TAG_FACTOR * true_focal, color=True)
    tag = float(p.model_store[1].focal_length_pixels)
    if len(p.model_store) != 1 or abs(tag / true_focal - FOCAL_TAG_FACTOR) > 1e-6 or p.skip_camera_param_relax:
        raise AssertionError(f"the survey's camera model is not the one wrong tag: {p.model_store}")
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps = []
    try:
        with _SolveRecorder() as rec, _BuildRecorder() as builds:
            while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
                state, rc = p.get_state(), p.state_run_count()
                n_solves, n_b, n_r = len(rec.solves), builds.builds, builds.refreshes
                scopes0 = {k: performance.get_timer_total(k) for k in CPR_SCOPES}
                t0 = time.perf_counter()
                p.iterate_once()
                _sync()
                steps.append(dict(
                    state=state, rc=rc, seconds=time.perf_counter() - t0,
                    lm=sum(sum(s["lm"]) for s in rec.solves[n_solves:]),
                    dims=[s["dims"] for s in rec.solves[n_solves:]],
                    builds=builds.builds - n_b, refreshes=builds.refreshes - n_r,
                    scopes={k: performance.get_timer_total(k) - scopes0[k] for k in CPR_SCOPES},
                    model=_model_line(p.model_store[1]), focal=float(p.model_store[1].focal_length_pixels),
                ))
                if len(steps) > 80:
                    raise AssertionError("the pipeline did not reach GENERATE_THUMBNAIL in 80 passes")
    finally:
        performance.enable_performance_counters(False)
    launches = ip_launches + hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()

    print(f"[calib] after INITIAL_PROCESSING: {len(steps)} iterate_once calls, {sum(st['seconds'] for st in steps):.4f} s")
    for state in PipelineState.ORDER:
        of = [st for st in steps if st["state"] == state]
        if of:
            print(f"[calib] {state}: {len(of)} passes, {sum(st['seconds'] for st in of):.4f} s, "
                  f"{sum(st['lm'] for st in of)} LM iterations (full solves), {sum(st['builds'] for st in of)} builds, "
                  f"{sum(st['refreshes'] for st in of)} refreshes")
    cpr = [st for st in steps if st["state"] == PipelineState.CAMERA_PARAMETER_RELAX]
    for st in cpr:
        rc = st["rc"]
        tier = f"focal, radial tier {min(max(rc - 1, 0), 3)}" + (", principal" if rc >= 4 else "")
        print(f"[calib] CAMERA_PARAMETER_RELAX pass {rc} ({tier}): {st['seconds']:.4f} s, LM {st['lm']}, "
              f"dims {st['dims']}, builds {st['builds']}, refreshes {st['refreshes']}; {st['model']}; "
              f"focal error {100 * abs(st['focal'] / true_focal - 1):.4f} %; scopes "
              + ", ".join(f"{k} {v:.3f}" for k, v in st["scopes"].items()))
    total = {k: sum(st["scopes"][k] for st in cpr) for k in CPR_SCOPES}
    cpr_s = sum(st["seconds"] for st in cpr)
    print(f"[calib] CAMERA_PARAMETER_RELAX shares of {cpr_s:.4f} s: "
          + ", ".join(f"{k} {v:.3f} s ({100 * v / cpr_s:.1f} %)" for k, v in total.items())
          + " (the model inversions are part of build and refresh)")
    print("[calib] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[calib]   {line}")
    print(f"[calib] peak memory allocated {peak / 2**30:.3f} GiB; Hamming kernel launches {launches} from "
          f"INITIAL_PROCESSING on; {int(performance.get_event_count('relax plan reuses'))} plan reuses")

    # one structure for the whole state, refreshed on every later pass; one refit, after the last pass
    if [st["builds"] for st in cpr] != [1, 0, 0, 0, 0, 0] or [st["refreshes"] for st in cpr] != [0, 1, 1, 1, 1, 1]:
        raise AssertionError(f"CAMERA_PARAMETER_RELAX did not build once and refresh five times: "
                             f"{[(st['builds'], st['refreshes']) for st in cpr]}")
    if [st["scopes"]["refit all edges"] > 0 for st in cpr] != [False] * 5 + [True]:
        raise AssertionError("the edges were not refitted exactly once, after the last pass")
    focal = float(p.model_store[1].focal_length_pixels)
    rel = abs(focal / true_focal - 1.0)
    print(f"[calib] focal {focal:.4f} px against the true {true_focal} (tag {tag:.1f}): error {100 * rel:.4f} % "
          f"(bound {100 * FOCAL_REL_BOUND} %, tag {100 * (FOCAL_TAG_FACTOR - 1):.1f} %)")
    if not (rel < FOCAL_REL_BOUND and rel < FOCAL_TAG_FACTOR - 1.0):
        raise AssertionError(f"the focal length was not recovered: {focal} against {true_focal}")
    _orientation_error(p, paths, quats_gt, "calib")
    herr, n_inside = _height_error(p, positions)
    print(f"[calib] mesh height error vs the relief at {n_inside} vertices inside the camera footprint: "
          f"median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if not n_inside or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        raise AssertionError(f"mesh does not follow the relief: {np.round(herr, 3).tolist()}")
    kept = emptied = 0
    for _, e in p.graph.edges():
        if len(e.payload.inlier_idx1):
            kept += 1
            if not np.isfinite(np.asarray(e.payload.ransac_relation)).all():
                raise AssertionError("an edge with inliers has a non-finite homography after the refit")
        else:
            emptied += 1
    print(f"[calib] after the refit: {kept} edges keep inliers (finite homographies), {emptied} emptied")
    if kept < len(paths):
        raise AssertionError(f"the refit left only {kept} edges with inliers")

    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        if not p.save_checkpoint(ck):
            raise AssertionError("save_checkpoint failed")
        saved_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        q = Pipeline(device="cuda")
        t0 = time.perf_counter()
        if not q.load_checkpoint(ck):
            raise AssertionError("load_checkpoint failed")
        loaded_s = time.perf_counter() - t0
        files = sorted(os.listdir(ck))
    worst_v, worst_c = _assert_same_after_checkpoint(p, q)
    print(f"[calib] checkpoint {files} ({size / 2**20:.2f} MiB): saved in {saved_s:.3f} s, loaded in {loaded_s:.3f} s; "
          f"state {q.get_state()}, graph, camera models and GPS index equal; mesh vertices within {worst_v:.2e} "
          f"(relative, bound {CHECKPOINT_VERTEX_REL}), clouds within {worst_c:.2e} m (bound {CHECKPOINT_CLOUD_M})")
    return launches + phase_ortho_tail(p, paths, positions, directory)


KEEP_GOING = False  # --keep-going: the ortho tail's checks report and go on, and the run fails at its end
FAILURES = []


def _fail(message):
    if not KEEP_GOING:
        raise AssertionError(message)
    print(f"[FAILED] {message}")
    FAILURES.append(message)


def _footprint_window(origin, px, shape_hw, lo_xy, hi_xy):
    """(row0, row1, col0, col1) of the raster over the world box lo..hi."""
    c0, c1 = int((lo_xy[0] - origin[0]) / px[0]), int((hi_xy[0] - origin[0]) / px[0]) + 1
    r0, r1 = int((origin[1] - hi_xy[1]) / px[1]), int((origin[1] - lo_xy[1]) / px[1]) + 1
    return max(r0, 0), min(r1, shape_hw[0]), max(c0, 0), min(c1, shape_hw[1])


def phase_ortho_tail(p, paths, positions, directory):
    """GENERATE_THUMBNAIL to COMPLETE on the calibrated pipeline ``p`` with
    every output path set; returns the Hamming kernel's launches in it."""
    out = os.path.join(directory, "ortho_out")
    os.makedirs(out)
    p.ortho_path, p.dsm_path = os.path.join(out, "ortho.tif"), os.path.join(out, "dsm.tif")
    p.camera_id_path, p.thumbnail_path = os.path.join(out, "camera_ids.tif"), os.path.join(out, "thumbnail.png")
    p.textured_obj_prefix = os.path.join(out, "model")
    tiles = []
    p.step_callback = lambda info: tiles.append(info.tile_update) if info.tile_update else None
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    seconds, last = {}, None
    try:
        for _ in range(12):
            state = p.get_state()
            t0 = time.perf_counter()
            last = p.iterate_once()
            _sync()
            seconds[state] = time.perf_counter() - t0
            if last == "DONE":
                break
    finally:
        performance.enable_performance_counters(False)
        p.step_callback = None
    launches = hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    if last != "DONE" or p.get_state() != PipelineState.COMPLETE:
        _fail(f"the pipeline did not reach COMPLETE: state {p.get_state()}, last return {last}")
    job = p._ortho_job
    print("[ortho] seconds per state: " + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.4f} s")
    print(f"[ortho] mosaic {job._width} x {job._height} px ({job._width * job._height / 1e6:.3f} MP), GSD "
          f"{job._gsd:.5f} m, {job._tiles_x} x {job._tiles_y} = {len(job._order)} tiles of {job.tile_size}, "
          f"{job._kc} candidate cameras a tile, taps {job.taps}, blend levels {job.blend_levels}; thumbnail mosaic "
          f"{p.thumbnail_mosaic.rgba.shape[1]} x {p.thumbnail_mosaic.rgba.shape[0]} px at {p.thumbnail_mosaic.gsd:.4f} m")
    print("[ortho] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[ortho]   {line}")
    print(f"[ortho] {len(job.correspondences)} correspondences, balance cost {job.balance.final_cost:.6g} "
          f"(success {job.balance.success}); image cache {job._cache.hits} hits / {job._cache.misses} misses, "
          f"{job.device_uploads} device uploads; {len(tiles)} tile updates; peak memory allocated "
          f"{peak / 2**30:.3f} GiB; Hamming kernel launches {launches}")

    # where a tile's time goes: the host's mesh interpolation, the render on
    # the card (dispatch to a synchronised end) and the pull of the layers,
    # for a tile under the cameras and for an empty corner tile
    from opencalibration_tpu_torch.ortho.ortho import _raster_grid

    for label, (tx, ty) in (("central", (job._tiles_x // 2, job._tiles_y // 2)), ("corner", (0, 0))):
        ts = job.tile_size
        _sync()
        t0 = time.perf_counter()
        job._ctx.mesh.interpolate_z(_raster_grid(job._bounds, job._gsd, tx * ts, ty * ts, ts, ts))
        t1 = time.perf_counter()
        disp = job._project_tile_dispatch(tx, ty)
        t2 = time.perf_counter()
        _sync()
        t3 = time.perf_counter()
        job._project_tile_finish(disp)
        t4 = time.perf_counter()
        print(f"[ortho] one {label} tile ({tx}, {ty}): interpolate_z on the host {t1 - t0:.4f} s; dispatch (with "
              f"its own interpolate_z) {t2 - t1:.4f} s, the card done {t3 - t2:.4f} s later; pull of the layers "
              f"{t4 - t3:.4f} s")

    # thumbnails
    shapes = {tuple(n.payload.thumbnail.shape) for _, n in p.graph.nodes() if n.payload.thumbnail is not None}
    if shapes != {THUMBNAIL_HW + (3,)} or any(n.payload.thumbnail is None for _, n in p.graph.nodes()):
        _fail(f"thumbnails are not all {THUMBNAIL_HW}: {shapes}")
    if not job.balance.success or len(job.correspondences) < 1000:
        _fail("the colour balance had too little to work with")
    if len(tiles) != len(job._order) or job._cache.misses != len(paths) or job.device_uploads != len(paths):
        _fail(f"tiles reported {len(tiles)} of {len(job._order)}; {job._cache.misses} decodes and "
                             f"{job.device_uploads} uploads for {len(paths)} images")

    # the files, read back
    t0 = time.perf_counter()
    ortho = geotiff.read_geotiff(p.ortho_path)
    img, origin, px, wkt = ortho
    cam = geotiff.read_geotiff(p.camera_id_path)
    dsm, dsm_origin, dsm_px, _ = geotiff.read_geotiff(p.dsm_path)
    dsm = dsm.reshape(dsm.shape[:2])
    levels = {k: geotiff.read_geotiff_overviews(v) for k, v in
              (("ortho", p.ortho_path), ("dsm", p.dsm_path), ("camera ids", p.camera_id_path))}
    print(f"[ortho] read back in {time.perf_counter() - t0:.2f} s: ortho {img.shape} {img.dtype}, origin "
          f"({origin[0]:.3f}, {origin[1]:.3f}), pixel {px[0]:.5f} m, levels {levels['ortho']}; camera ids "
          f"{cam[0].shape} {cam[0].dtype}, levels {levels['camera ids']}; DSM {dsm.shape} {dsm.dtype}, pixel "
          f"{dsm_px[0]:.5f} m, levels {levels['dsm']}; WKT {'present' if wkt else 'absent'}")
    b = job._bounds
    if (img.shape != (job._height, job._width, 4) or img.dtype != np.uint8
            or img.shape[0] * img.shape[1] > p.ortho_max_megapixels * 1e6
            or abs(origin[0] - b.min_x) > 1e-6 or abs(origin[1] - b.max_y) > 1e-6
            or abs(px[0] - job._gsd) > 1e-9 or abs(px[1] - job._gsd) > 1e-9 or not wkt
            or len(levels["ortho"]) != 4 or levels["ortho"][0] != img.shape[:2]):
        _fail("the orthomosaic GeoTIFF does not read back as written")
    ids = cam[0].reshape(cam[0].shape[:2])
    if ids.dtype != np.uint64 or ids.shape != img.shape[:2] or cam[1] != origin or cam[2] != px:
        _fail("the camera-id GeoTIFF does not match the orthomosaic's raster")
    if (dsm.dtype != np.float32 or dsm.ndim != 2 or len(levels["dsm"]) != 4
            or abs(dsm_origin[0] - b.min_x) > 1e-6 or abs(dsm_origin[1] - b.max_y) > 1e-6):
        _fail("the DSM GeoTIFF does not read back as written")
    for name in ("thumbnail.png", "model.obj", "model.mtl", "model.png"):
        if os.path.getsize(os.path.join(out, name)) == 0:
            _fail(f"{name} is empty")

    # the local frame starts at the first camera: its offset to the survey's frame
    nodes = _by_path(p)
    offset = positions[0] - np.asarray(nodes[paths[0]].position)
    cam_local = np.stack([np.asarray(nodes[path].position) for path in paths])
    lo, hi = cam_local[:, :2].min(0), cam_local[:, :2].max(0)

    # coverage and camera ids
    r0, r1, c0, c1 = _footprint_window(origin, px, img.shape[:2], lo, hi)
    covered = img[..., 3] == 255
    share = float(covered[r0:r1, c0:c1].mean())
    id_of = {n.payload.path: nid for nid, n in p.graph.nodes()}
    seen = set(np.unique(ids[r0:r1, c0:c1]).tolist()) | set(np.unique(ids[::7, ::7]).tolist())
    print(f"[ortho] covered inside the camera footprint ({r1 - r0} x {c1 - c0} px): {share:.5f} (bound "
          f"{ORTHO_COVERED_SHARE}); covered overall {float(covered.mean()):.5f}; camera ids seen: {len(seen - {0})} "
          f"of {len(paths)} cameras")
    if share < ORTHO_COVERED_SHARE:
        _fail(f"only {share:.4f} of the camera footprint is covered")
    if not seen <= set(id_of.values()) | {0}:
        _fail("the camera-id raster holds values that are no node id")
    if (ids[~covered] != 0).any() or (ids[covered] == 0).any():
        _fail("the camera-id raster is not 0 exactly where nothing is covered")
    for i, path in enumerate(paths):
        col, row = int((cam_local[i, 0] - origin[0]) / px[0]), int((origin[1] - cam_local[i, 1]) / px[1])
        near = {id_of[q] for j, q in enumerate(paths)
                if np.linalg.norm(positions[j, :2] - positions[i, :2]) <= 1.5 * SPACING}
        if int(ids[row, col]) not in near:
            _fail(f"under camera {i}'s nadir the raster names camera id {int(ids[row, col])}")

    # the DSM against the relief, at the raster's own coordinates inside the footprint
    dr0, dr1, dc0, dc1 = _footprint_window(dsm_origin, dsm_px, dsm.shape, lo, hi)
    z = dsm[dr0:dr1, dc0:dc1]
    gx, gy = np.meshgrid(dsm_origin[0] + dsm_px[0] * np.arange(dc0, dc1), dsm_origin[1] - dsm_px[1] * np.arange(dr0, dr1))
    truth = S.relief_height(torch.as_tensor(np.stack([gx + offset[0], gy + offset[1]], -1)), RELIEF_M,
                            RELIEF_WAVELENGTH_M).numpy()
    valid = z != -32767.0
    herr = np.abs(z + offset[2] - truth)[valid]
    print(f"[ortho] DSM vs the relief at {int(valid.sum())} pixels inside the camera footprint ({float(valid.mean()):.4f} "
          f"valid): median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if valid.mean() < 0.99 or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        _fail("the DSM does not follow the relief")

    # the orthomosaic against the scene's own texture
    window = _footprint_window(origin, px, img.shape[:2], lo - ORTHO_MARGIN_M, hi + ORTHO_MARGIN_M)
    t0 = time.perf_counter()
    median_l, win_share = ortho_cases.median_l_error(ortho, positions, texture=FULL["texture"], offset_xy=offset[:2],
                                                     window=window, smooth_m=ORTHO_SMOOTH_M)
    print(f"[ortho] orthomosaic L against the scene's texture, window {window} ({win_share:.4f} covered): median "
          f"|error| over {ORTHO_SMOOTH_M} m boxes {median_l:.3f} levels of 255 (bound {ORTHO_MEDIAN_L}; "
          f"{time.perf_counter() - t0:.2f} s)")
    if not median_l <= ORTHO_MEDIAN_L:
        _fail(f"the orthomosaic is {median_l} L levels from the scene")
    del ortho, img, ids, cam, dsm, covered

    # the balance must flatten the exposure gains: one job at a lower cap,
    # blended with its balance and with none
    t0 = time.perf_counter()
    check = OrthoJob(p.surfaces, p.graph, p.model_store, p.geocoord, max_megapixels=BALANCE_CHECK_MEGAPIXELS,
                     device="cuda")
    check.pass_layers()
    check.solve_balance()
    errs = {}
    for name in ("balanced", "unbalanced"):
        path = os.path.join(out, f"check_{name}.tif")
        balance = check.balance
        if name == "unbalanced":
            check.balance = None
        check.pass_blend(path)
        check.balance = balance
        back = geotiff.read_geotiff(path)
        w = _footprint_window(back[1], back[2], back[0].shape[:2], lo - ORTHO_MARGIN_M, hi + ORTHO_MARGIN_M)
        errs[name] = ortho_cases.median_l_error(back, positions, texture=FULL["texture"], offset_xy=offset[:2],
                                                window=w, smooth_m=ORTHO_SMOOTH_M)[0]
    print(f"[ortho] balance check at {BALANCE_CHECK_MEGAPIXELS} MP ({check._width} x {check._height} px, "
          f"{len(check._order)} tiles, {len(check.correspondences)} correspondences, "
          f"{time.perf_counter() - t0:.2f} s): median |L error| {errs['balanced']:.3f} with the colour balance, "
          f"{errs['unbalanced']:.3f} without")
    if not (errs["balanced"] < errs["unbalanced"] and errs["balanced"] <= ORTHO_MEDIAN_L):
        _fail(f"the colour balance did not flatten the exposure gains: {errs}")

    # the solve is reproducible to the bit on the card
    cam_xy = {nid: np.asarray(n.payload.position[:2]) for nid, n in p.graph.nodes()}
    t0 = time.perf_counter()
    first = solve_color_balance(job.correspondences, cam_xy, device="cuda")
    again = solve_color_balance(job.correspondences, cam_xy, device="cuda")
    va, vb = ortho_cases.balance_vector(first), ortho_cases.balance_vector(again)
    same = np.array_equal(va, vb) and first.final_cost == again.final_cost
    same_as_job = np.array_equal(va, ortho_cases.balance_vector(job.balance))
    print(f"[ortho] solve_color_balance twice on the card ({len(va)} parameters, {time.perf_counter() - t0:.2f} s): "
          f"bit-identical {same}; equal to the pipeline's own solve {same_as_job}; largest |L offset| "
          f"{max(abs(q.lab_offset[0]) for q in first.per_image_params.values()):.3f}")
    if not (same and same_as_job):
        _fail("two colour-balance solves of the same correspondences differ")
    return launches


def phase_ortho_cuda_vs_cpu():
    """The ortho tail from one ground-truth state on the card and on the CPU."""
    with tempfile.TemporaryDirectory() as d:
        state = ortho_cases.ground_truth_state(d)
        t0 = time.perf_counter()
        on_card = ortho_cases.run_ortho_tail(state, d, "cuda")
        _sync()
        t1 = time.perf_counter()
        on_cpu = ortho_cases.run_ortho_tail(state, d, "cpu")
        t2 = time.perf_counter()
        got = ortho_cases.compare_ortho_tails(on_card, on_cpu)
        median_l, share = ortho_cases.median_l_error(on_card["ortho_path"], state["positions"])
    job = on_card["job"]
    print(f"[ortho-cuda-vs-cpu] 2x3 at 320x240, {job._width} x {job._height} px in {len(job._order)} tiles of "
          f"{job.tile_size}: card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; {got['correspondences']} correspondences, the "
          f"same cameras on both; balance parameters within {got['balance_max_abs']:.2e} (bound "
          f"{ortho_cases.BALANCE_ABS}); RGBA bytes equal {got['rgba_equal_share']:.5f} (bound "
          f"{ortho_cases.RGBA_EQUAL_SHARE}), largest difference {got['rgba_max_levels']} (bound "
          f"{ortho_cases.RGBA_MAX_LEVELS}); camera ids equal over the {got['covered_by_both']:.3f} covered by both; "
          f"median |L error| against the scene {median_l:.3f} over {share:.3f} covered")


def _shared_solve(graph, gps_positions, model_store, surfaces, device):
    """Groups of SHARED_GROUP_SIZE over ``graph`` with the focal free,
    stacked by the stage into one shared-intrinsics batch and solved jointly
    in float32 on ``device``. Returns (batch, solved params on the host,
    info, seconds)."""
    stage = ST.RelaxStage(device=device, dtype=torch.float32)
    stage.init(graph, [], gps_positions, model_store, relax_all=True, disable_parallelism=False,
               options=RelaxOptions(orientation=True, ground_mesh=True, focal=True))
    stage.dispatch(graph, surfaces)
    batch = stage.last_plan.batch
    if batch is None or not batch.shared_intrinsics or batch.num_groups < 2:
        raise AssertionError("the survey did not split into several intrinsics groups")
    t0 = time.perf_counter()
    solved, info = GS.solve_group_batch_shared(batch, stage.last_plan.pre_solve, max_iterations=SHARED_MAX_ITERATIONS)
    if batch.free.is_cuda:
        _sync()
    return batch, GS.fetch_solved(solved), info, time.perf_counter() - t0


def phase_shared_solver(entry):
    """The joint solver of several intrinsics groups, CUDA against CPU, from
    the state in which phase 8's relief survey entered CAMERA_PARAMETER_RELAX."""
    graph, gps_positions, model_store, entry_surfaces = entry
    print(f"[shared] the {MESH['rows']}x{MESH['cols']} relief survey at {MESH['width']}x{MESH['height']} at the entry "
          f"of CAMERA_PARAMETER_RELAX (phase 8): {graph.size_nodes()} nodes, {graph.size_edges()} edges, mesh "
          f"{entry_surfaces[0].mesh.num_vertices} vertices")
    group_size = ST.INTRINSICS_GROUP_SIZE
    ST.INTRINSICS_GROUP_SIZE = SHARED_GROUP_SIZE
    try:
        out = {}
        for device in ("cuda", "cpu"):
            surfaces = copy.deepcopy(entry_surfaces)
            batch, solved, info, seconds = _shared_solve(graph, gps_positions, dict(model_store), surfaces, device)
            lay = batch.layout
            for name in ("mesh_z", "focal", "principal", "radial", "tangential"):
                leaf = getattr(solved, name)
                if not all(np.array_equal(leaf[0], leaf[g]) for g in range(1, batch.num_groups)):
                    raise AssertionError(f"on {device} the groups' copies of {name} differ")
            print(f"[shared] {device}: {batch.num_groups} groups, layout C {lay.C} V {lay.V} M {lay.M} (T = {lay.dim}), "
                  f"{int(info.iterations)} LM iterations in {seconds:.3f} s, cost {float(info.initial_cost):.6g} -> "
                  f"{float(info.final_cost):.6g}, focal {float(batch.params.focal[0, 0]):.4f} -> "
                  f"{float(solved.focal[0, 0]):.4f}; every group's shared tail equal bit for bit")
            quats = {}
            for g, b in enumerate(batch.builts):
                pg = GS.extract_group_params(batch, solved, g)
                for nid, slot in b.cam_index.items():
                    if slot < b.num_opt:
                        quats.setdefault(nid, pg.quats[slot])
            out[device] = (float(solved.focal[0, 0]), quats, int(info.iterations))
    finally:
        ST.INTRINSICS_GROUP_SIZE = group_size
    (f_gpu, q_gpu, _), (f_cpu, q_cpu, _) = out["cuda"], out["cpu"]
    if q_gpu.keys() != q_cpu.keys():
        raise AssertionError("the CUDA and CPU groups hold different cameras")
    ang = np.asarray([_angles_deg(q_gpu[k], q_cpu[k]) for k in sorted(q_gpu)])
    rel = abs(f_gpu - f_cpu) / f_cpu
    print(f"[shared] CUDA vs CPU (float32): focal {f_gpu:.4f} vs {f_cpu:.4f} ({rel:.2e} relative, bound "
          f"{SHARED_FOCAL_REL}); orientations max {ang.max():.5f} deg apart (bound {SHARED_DEG})")
    if not (np.isfinite(ang).all() and rel <= SHARED_FOCAL_REL and ang.max() <= SHARED_DEG):
        raise AssertionError("the shared solver's CUDA and CPU results disagree")


def main(argv=()):
    """With no arguments: every phase, then the ``kernels`` line and the
    ``ok`` line. ``--phases 1,2,9`` runs those phases alone (1 and 2 always
    run) and prints neither line; ``--keep-going`` lets the ortho tail's
    checks report and go on, and fails at the end."""
    global KEEP_GOING
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(list(argv))
    only = {int(x) for x in args.phases.split(",") if x}
    KEEP_GOING = args.keep_going
    want = lambda n: not only or n in only  # noqa: E731
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    kernel = phase_kernel(smi) if want(3) else None
    if want(4):
        phase_cuda_vs_cpu()
    step_launches = phase_full_size() if want(5) else None
    if want(6):
        phase_pipeline_cuda_vs_cpu()
    ip_launches = mesh_launches = calib_launches = relief_entry = None
    if want(7):
        with tempfile.TemporaryDirectory() as d:
            p, paths, _, quats_gt, ip_launches = phase_pipeline_full_size(d, 0.0, "pipeline")
            _orientation_error(p, paths, quats_gt, "pipeline")
        del p
    if want(8) or want(10):  # phase 10 starts from a state of phase 8
        with tempfile.TemporaryDirectory() as d:
            mesh_launches, relief_entry = phase_mesh_refinement(d)
    if want(9):
        with tempfile.TemporaryDirectory() as d:
            calib_launches = phase_camera_relax(d)
    if want(10):
        phase_shared_solver(relief_entry)
    if want(11):
        phase_ortho_cuda_vs_cpu()
    _assert_standalone("end")
    print(f"[end] {time.perf_counter() - t_start:.1f} s")
    if FAILURES:
        raise AssertionError(f"{len(FAILURES)} checks failed: {FAILURES}")
    if only:
        print(f"partial run (phases {sorted(only | {1, 2})}): no kernels line, no ok line")
        return 0
    print(json.dumps({"kernels": [dict(
        name="hamming_top2", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL_REPLACES,
        launches=calib_launches,
        paths={"pipeline INITIAL_PROCESSING..FINAL_GLOBAL_RELAX with CAMERA_PARAMETER_RELAX, 24 images, relief, "
               "... to COMPLETE": calib_launches,
               "pipeline INITIAL_PROCESSING..FINAL_GLOBAL_RELAX, 9 images at 320x240, relief": mesh_launches,
               "pipeline INITIAL_PROCESSING, flat": ip_launches, "calibration_step": step_launches},
        **kernel,
    )]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
