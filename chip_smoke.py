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
   a cluster with ties across splits, and at the main paths' shapes
   [42, 2048, 2048], [16, 1024, 1024], the bench twin's calibration step
   [42, 1024, 1024] and the bench_kernels twin's line [1, 4096, 4096] (every
   column valid); then at the four shapes the kernel,
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
7. the pipeline on a flat survey past one pose group: 56 PGM images (7 x 8,
   12 m apart) at 1600 x 1200 with the pipeline's defaults, from
   INITIAL_PROCESSING (seconds per ``iterate_once``, the stage counters,
   nodes / edges / groups, peak memory, kernel launches, the kernel against
   its plain version on one link chunk, the orientation error: median 2
   degrees, and every camera beyond 5 degrees one that its last relax
   co-optimised as a halo camera held by the downwards prior alone, whose
   heading no residual reaches, as the JAX package does with it) through
   MESH_REFINEMENT and FINAL_GLOBAL_RELAX with the camera parameters
   skipped. Every relax pass of two pose groups or more is one batched
   solve (``solve_group_batch``); per pass the groups, their bucketed lanes,
   each group's tangent dimension, the batch's T and route, the LM
   iterations per lane and the seconds, then plan reuses, peak memory and the
   counters. Checked: every MESH_REFINEMENT pass is one batched solve of at
   least 2 groups; FINAL_GLOBAL_RELAX reuses its plan; orientations against
   the truth (median 2, maximum 5 degrees); the mesh's surface against the
   flat ground over the camera footprint (1 m, 4 m); the last
   MESH_REFINEMENT batch solved again on the card by ``solve_groups`` (one
   group after another) within 1e-4 rad and 1e-4 m of the batched result and
   by ``solve_group_batch`` once more, bit for bit; one lane of it solved by
   the dense and the matrix-free linear solvers (their difference and time
   per LM iteration) and by the matrix-free one twice, bit for bit;
8. a 9-image survey (3 x 3 at 320 x 240; the full image size over this
   relief is phase 9's) rendered over terrain with
   8 m of sinusoidal relief (70 m wavelength), driven from
   INITIAL_PROCESSING through MESH_REFINEMENT (its finest grid level 1,
   which caps it at 11 passes) to the entry of CAMERA_PARAMETER_RELAX (both
   cut for time;
   phase 10 starts from that state): seconds per ``iterate_once`` and per state, mesh
   vertices and triangles and the grid level after every pass, every
   solve's tangent dimension and route, LM iterations, peak
   memory, the stage counters, the orientation error after
   INITIAL_PROCESSING (printed; the ground-plane relax cannot follow the
   relief) and at the end (bounded), and the final mesh's height error
   against the relief;
9. the whole pipeline at full size, the main path: the 24-image survey over
   the same relief, written in colour as JPEG (quality 95, the port's own
   encoder) with a seeded +-10 % exposure gain per image, its geotags' focal
   length 5 % above the true 2000 px, from
   ``add(paths)`` with the pipeline's defaults (float64 relax problems, as
   the runner's) through INITIAL_PROCESSING,
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
   GENERATE_THUMBNAIL, DENSIFY_MESH, DENSE_MESH_RELAX, GENERATE_LAYERS,
   COLOR_BALANCE and BLEND_LAYERS to COMPLETE with the reference's defaults
   (tiles of 256, 3 x 3 taps, four blend levels; the raster capped at 32 MP, a
   half of the default, for time), the dense mesh
   on and every output path set: the dense features per image, pairs
   matched and ``gated_match``'s time a pair, matches, tracks and points
   kept (checked: at least 2.5 x the sparse track points, their heights and
   the refined mesh's against the relief), peak memory per state, the JPEG
   decode and encode times per call and where they ran, seconds per state,
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
   for bit; then the runner's own outputs written through
   ``apps/pipeline_runner.py::write_outputs`` and read back;
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
   within the stated tolerances;
12. the CLI end to end: ``python -m
   opencalibration_tpu_torch.apps.pipeline_runner --device cuda`` in a
   subprocess where jax, the JAX package, cv2 and PIL cannot be imported,
   on a flat 2 x 3 JPEG survey at 320 x 240 (phase 9 runs the relief),
   with every flag of
   the JAX package's tests/test_cli.py and ``--dense-mesh 1``: exit 0, the
   reference's 14 artifacts, the graph JSON and the checkpoint read back,
   and ``extract_camera_db`` run on the checkpoint writing its focal;
13. the library's entry points that no pipeline state calls, on the card
   against the CPU: ``extract_features(diffusion="fed")`` on a 400 x 300 crop
   of two phase-7 images (equal keypoint counts, 99 % within 0.01 px,
   99.5 % of the descriptor bits equal where the keypoints are), then at
   1600 x 1200 on the
   card alone (time, keypoints, peak memory); ``ransac`` at 2048
   correspondences and 2048 hypotheses on the same uniforms: "fundamental"
   on two scenes with 15 % outliers (models equal up to sign within 1e-4,
   inlier flags 99.5 % equal, scores within 1 %), "essential" on the same
   scenes held to their truth (the precision of its inliers 0.98: a 5-point
   hypothesis is a vector of a 4-dimensional null space that each device's
   eigen solver picks its own way) and on the first scene without outliers
   to the CPU (flags and scores as above) and to the true essential matrix
   (1e-2); DEGENSAC from a plane-degenerate fundamental matrix of a scene
   with 85 % of its points on one plane, where it must fire on both devices
   (decision equal, models within 1e-4 up to sign, flags 99.5 % equal);
   ``relax`` with ``points_3d`` on phase 6's 2 x 3 survey by its own route
   (CG: orientations within 0.1 degrees, points within 5e-3 m, its steps
   are inexact) and by the dense route for 3 LM iterations (within 1e-6
   degrees and 1e-6 m; cut for time);
   ``save_reference_graph`` of phase 7's final graph and
   ``load_reference_graph`` (equal ids, descriptors bit for bit, poses within
   1e-12, the file's size);
14. the multi-device paths, their shards listed on cuda:0 (one process
   drives them, ``parallel/mesh.py``): (a) ``run_sharded_ba`` on four
   shards against one shard with the same four groups (float32, within the
   JAX package's bound between device counts, the shared focal within 1 px
   of the truth and equal on every shard); (b) ``dryrun_multidevice`` on two
   shards and ``entry`` on the card against the CPU; (c) phase 7's last
   MESH_REFINEMENT batch (two lanes) by ``solve_group_batch`` on two shards
   against one device, bit for bit or within 1e-12, with both times; (d)
   the joint solver at full size: phase 9's state at the entry of
   CAMERA_PARAMETER_RELAX split into three intrinsics groups of 8 with the
   focal free, in float64, by ``solve_group_batch_shared`` on one shard and
   on three (within 1e-9 relative, equal iterations), the focal against the
   JAX package's joint solve of the same state (1e-6 relative; it lands 5.5 %
   off the truth, where phase 9's one group recovers 1.6 %: printed beside),
   iterations, seconds and peak memory. On a host with several cards (c) and
   (d) run again on distinct cards;
15. the bench twins at survey scale (``opencalibration_tpu_torch/bench``):
   (a) ``python -m opencalibration_tpu_torch.bench.bench`` in a subprocess
   with ``BENCH_SKIP_CPU_E2E=1``, run beside (b) and (c) on the same card
   for the script's time: its one JSON line parses, ``value`` > 0,
   both 24-image legs reach COMPLETE with the three GeoTIFFs non-empty, the
   median pose error at most 0.02 m and the focal error at most 12 px (3 %
   of 400); (b) bench_e2e.py's 104-image survey (8 x 13 gray JPEGs at
   320 x 240) in one pipeline in batches of 16 for 5 INITIAL_PROCESSING
   iterates, then a checkpoint and ``ip_sidecar.json``, and the pipeline
   dropped; (c) ``bench_e2e.run_config(104, batch_size=16)`` with
   ``BENCH_E2E_CHECKPOINT`` on that directory resumes there, its roll-back
   keeping some of the graph's nodes and not all, and runs to COMPLETE
   (ortho off, as the twin's default): every one of the 104 paths in the
   graph exactly once, the
   bounds of (a), at least one MESH_REFINEMENT pass of 3 pose groups or more
   in one batched solve, and per state its seconds, solves, groups, lanes,
   tangent dimensions, routes and LM iterations;
16. the remaining twins, each in a process of its own started after 15 (c)
   and run beside 15 (a) (``TWIN_RUNS``; for the script's time, so their
   seconds are not for comparison): ``bench_kernels`` (its five lines, every
   roofline share and fraction in (0, 1.05], the kernel launched),
   ``bench_lm_solvers 150,400,4096`` (both routes), ``bench_extract_profile
   2`` (the stage table), ``bench_fed_ab`` (both modes, 42 pairs, the
   repeatability in (0, 1.05]) and ``bench_overlap_ab`` at 104 images in
   batches of 16 (seven batches, so the decode, link and relax of three
   batches overlap from the third on), one process for the ``serial`` leg
   and one for ``overlap``, each stopped after INITIAL_PROCESSING with its
   checkpoint: both legs hold the same nodes and edges, and their poses are
   compared (the gap printed). Each exits 0 and prints the card's line
   first.

The ``kernels`` line gives each kernel's launches on the main path, phase 9
(INITIAL_PROCESSING through the camera parameters, the dense mesh and the
ortho tail to COMPLETE), and on the paths of phases 12 (counted in the
runner's own process), 8, 7 (INITIAL_PROCESSING to the end of
FINAL_GLOBAL_RELAX), 5, 14 (the multi-device paths, where no link runs), 15 (the bench twin, counted in its
own process, and the resumed 104-image run) and 16 (the bench_kernels twin's kernel line, counted in its own
process), each taken with the counter set to 0
just before the path and read just after it, and phase 3's times and bounds
(``*_link`` at the link's shape, ``*_bench`` at the bench twin's, ``*_bench_kernels`` at the bench_kernels
twin's). Run from the repository root with
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

from opencalibration_tpu_torch.bench import bench as BB
from opencalibration_tpu_torch.bench import bench_e2e as BE
from opencalibration_tpu_torch.bench import bench_kernels as BK
from opencalibration_tpu_torch.dense import dense_stereo as DS
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.ops import models as M
from opencalibration_tpu_torch.ops import ransac as R
from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
from opencalibration_tpu_torch.parallel import dryrun as DR
from opencalibration_tpu_torch.parallel import group_solver as GS
from opencalibration_tpu_torch.parallel import sharded_ba as SBA
from opencalibration_tpu_torch.pipeline import calibration as C
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.relax import lm as LM
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.relax.tangent import FIELDS
from opencalibration_tpu_torch.io import geotiff
from opencalibration_tpu_torch.io.jpeg import decode_jpeg
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
# phase 7's survey: a near-square grid just past POSE_GROUP_SIZE images, so
# every multi-group relax pass splits it into two pose groups
MULTI = dict(FULL, rows=7, cols=8)
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
# the serial group solve against the batched one: the reference's own floor
# between its serial and batched paths
SERIAL_RAD, SERIAL_M = 1e-4, 1e-4
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
# phase 9's raster cap: half the reference's 64 MP, for the script's time. Nine
# tenths of the raster's tiles hold no image and each costs host time (ROADMAP
# P8); at 64 MP GENERATE_LAYERS and BLEND_LAYERS took 200 of the script's 979 s,
# at 16 MP 63 s (NVIDIA H100 80GB HBM3, 700 W). No phase runs the tail at 64 MP:
# the bench twins' 24-image rasters of phase 15 stay under 1 MP
ORTHO_MEGAPIXELS = 32.0
# MESH_REFINEMENT's finest grid level on phase 8's pipeline: 1 in place of the
# pipeline's 3, cut for time. It also caps the passes at 5 x (1 + 1) + 1 = 11
# (phase 9 runs the default's 21); over this relief every pass adds triangles,
# so all 11 stay at level 0, and the mesh follows the relief within the bounds.
# (Phase 7 keeps its levels: phase 14 (c) solves its last MESH_REFINEMENT batch
# again, and a level-0 batch parted 1.4e-12 on two shards.)
MESH_GRID_LEVELS = 1
GAIN_SPREAD = 0.1
BALANCE_CHECK_MEGAPIXELS = 2.0
THUMBNAIL_HW = (43, 58)  # of a 1600 x 1200 image
# DENSIFY_MESH: the dense cloud against the sparse track points (the JAX
# package's tests/test_dense.py)
DENSE_OVER_SPARSE = 2.5
# the dense points' heights: the median as the mesh's, the 4 m bound on the
# 90th percentile, as the JAX package's own dense test bounds its points
# (its maximum is an outlier's: a two-ray track from neighbouring images, a
# 12 m baseline at 60 m, passes the 8 px reprojection gate far off the ground)
DENSE_OUTLIER_PERCENTILE = 90
# the shared solver in float32, CUDA against CPU, on the 3 x 3 relief survey
SHARED_GROUP_SIZE, SHARED_MAX_ITERATIONS = 3, 50
SHARED_FOCAL_REL, SHARED_DEG = 5e-3, 0.1
# phase 13: the fed extraction's crop (rows, columns) and keypoint bounds,
# card against CPU; RANSAC's size and bounds; the points relax's bounds; the
# interchange's pose bound
FED_CROP_HW, FED_MAX_FEATURES, FED_XY_PX, FED_XY_SHARE = (300, 400), 1024, 0.01, 0.99
# descriptor bits of equal keypoints, card against CPU: a bit compares two
# smoothed samples, and the card's convolutions sum in another order, so a
# near-tie flips (tests/test_torch_features.py holds the port to the
# reference the same way)
FED_BIT_SHARE = 0.995
RANSAC_N, RANSAC_K, RANSAC_MODEL_REL, RANSAC_INLIER_SHARE, RANSAC_SCORE_REL = 2048, 2048, 1e-4, 0.995, 1e-2
RANSAC_SEEDS = (5, 6)  # two scenes with outliers; the first also without
# the essential RANSAC's inliers against the scene's truth on the scenes with
# outliers (other picks in the 5-point null space, on the CPU,
# tools/torch_essential_bases.py: precision 0.9888-0.9988, recall 0.81-1.00
# over 16 runs), and its model against the true essential matrix without
# outliers (at most 1.2e-3 over 8 runs)
ESSENTIAL_PRECISION, ESSENTIAL_TRUTH = 0.98, 1e-2
# DEGENSAC's scene: this share of the points on one plane, and the seed
DEGENSAC_PLANAR, DEGENSAC_SEED = 0.85, 7
# the points problem of the 2 x 3 survey routes to CG (T = 2111); its inexact
# steps carry the card's summation order into another iteration path (43
# against 42 LM iterations, points 1.88e-3 m apart on an NVIDIA H100 80GB
# HBM3 at 700 W), where a pixel of this survey covers 0.15 m of ground
POINTS_DEG, POINTS_M = 0.1, 5e-3
# the same problem by the dense route (Cholesky) on both devices: exact steps,
# so the two devices stay together iteration by iteration; compared after a
# few iterations (the CPU took 26.5 s for the 16 to convergence)
POINTS_DENSE_DEG, POINTS_DENSE_M, POINTS_DENSE_ITERATIONS = 1e-6, 1e-6, 3
INTERCHANGE_POSE = 1e-12
# phase 14: the sharded bundle adjustment's float32 step bound between shard
# counts (the JAX package's tests/test_sharded_ba.py) and its focal bound; the
# independent lanes on two shards against one device: bit for bit, or each
# leaf within this bound times its largest magnitude, at least 1 (absolute
# in the parameters' units near 0: phase 7's flat ground has heights of 2 cm).
# A lane's last bits still depend on its batch: the lane-batched LM pins
# cuSOLVER, which took the factorisations out (tools/torch_shard_bits.py),
# and the batched products remain; the joint solver at full size: groups of
# 8 images, shards against one shard
SHARDED_BA_TOL, SHARDED_BA_FOCAL_PX = dict(atol=2e-4, rtol=1e-5), 1.0
LANES_SHARDED_REL = 1e-12
SCALE_GROUP_SIZE, SCALE_SHARDS, SCALE_REL = 8, 3, 1e-9
# the JAX package's own joint solve of phase 9's CAMERA_PARAMETER_RELAX entry
# state in three groups of 8 (the state captured on the card, replayed on the
# CPU: tools/torch_joint_at_scale.py; the port's CPU replay 1.5e-15 from it).
# It lands 5.54 % above the true 2000 px, where one group recovers 1.57 %
# (2031.3613 px, phase 9's pass 0), so the three-group focal is held to the
# reference, within the shared solver's parity bound, not to the truth
SCALE_REFERENCE_FOCAL, SCALE_REFERENCE_REL = 2110.7832, 1e-6
# phase 15: the bench twins' bounds against the render's truth (the JAX
# package's own runs of these surveys read 0.000-0.001 m; 12 px is 3 % of the
# true 400 px, the focal bound of phase 9), the resumed survey, its batch and
# cut (after 5 iterates batches 1-3 are relaxed, 4 linked and 5 loaded, so
# the roll-back keeps the nodes of 1-3 that batch 4's edges do not reach) and
# the pose groups one MESH_REFINEMENT solve must reach (POSE_GROUP_SIZE 50)
BENCH_POSE_M, BENCH_FOCAL_PX = 0.02, 12.0
BENCH_IMAGES, BENCH_CUT_BATCH, BENCH_CUT_ITERATES, BENCH_MIN_POSE_GROUPS = 104, 16, 5, 3
BENCH_GEOTIFFS = ("ortho.tif", "dsm.tif", "camera_ids.tif")
KERNEL_SOURCE = "opencalibration_tpu_torch/csrc/hamming_top2.cu"
KERNEL_REPLACES = "opencalibration_tpu/ops/hamming_pallas.py:43"
# phase 16: the twins each run in a process of its own (python -m
# opencalibration_tpu_torch.bench.<twin> ...), beside phase 15's bench process;
# every roofline share and fraction they print lies in (0, TWIN_FRACTION_MAX]
TWIN_RUNS = {
    "kernels": ["bench_kernels"],
    "lm_solvers": ["bench_lm_solvers", "150,400,4096"],
    "extract_profile": ["bench_extract_profile", "2"],
    "fed_ab": ["bench_fed_ab"],
    **{f"overlap_{leg}": ["bench_overlap_ab", str(BENCH_IMAGES), leg, "--stop-after", PipelineState.INITIAL_PROCESSING,
                          "--batch-size", str(BENCH_CUT_BATCH)]
       for leg in ("serial", "overlap")},
}
TWIN_FRACTION_MAX = 1.05
TWIN_TIMEOUT_S = 600
TWIN_TILT_DEG = 5.0  # bench_fed_ab's median tilt of the relaxed cameras from nadir
TWIN_FED_PAIRS = 42  # bench.py's 24 images, each linked to its 3 nearest
CHILDREN = []  # every process the script starts, stopped at its end


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
    bound_ms, bound_by = BK.hamming_top2_bound(*p1.shape[:2], p2.shape[1])
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
    bench = (f"bench twin's calibration step [42, {BB.MAX_FEATURES}, {BB.MAX_FEATURES}]",) + HC.main_path_case(
        rng, 42, BB.MAX_FEATURES)
    n = BK.HAMMING_N
    d1, d2 = BK.hamming_inputs(n, device="cpu")
    every = torch.ones((1, n), dtype=torch.bool)
    twin = (f"bench_kernels twin's line [1, {n}, {n}], every column valid", d1[None], d2[None], every, every)
    max_err = 0.0
    for name, p1, p2, v1, v2 in HC.kernel_cases(rng) + [split, calib, link, bench, twin]:
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
    bench_out = _timed(*(t.to(dev).contiguous() for t in bench[1:]), f"[42, {BB.MAX_FEATURES}, {BB.MAX_FEATURES}]",
                       smi)
    twin_out = _timed(*(t.to(dev).contiguous() for t in twin[1:]), f"[1, {n}, {n}]", smi)
    return dict(max_abs_err=max_err, **out, **{f"{k}_link": v for k, v in link_out.items()},
                **{f"{k}_bench": v for k, v in bench_out.items()},
                **{f"{k}_bench_kernels": v for k, v in twin_out.items()})


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


CODEC_KEYS = ("jpeg: decode", "jpeg: encode")  # io/jpeg.py's scopes


def _codec_counts():
    finished = performance.spans()
    return {k: (sum(s.name == k for s in finished), performance.get_timer_total(k)) for k in CODEC_KEYS}


def _codec_line(label, where, before=None):
    """The port's JPEG codec calls under the performance counters (since
    ``before``, a ``_codec_counts()``, or their last reset): calls and host
    milliseconds a call."""
    now = _codec_counts()
    for k in CODEC_KEYS:
        n, total = now[k][0] - (before or {}).get(k, (0, 0.0))[0], now[k][1] - (before or {}).get(k, (0, 0.0))[1]
        if n:
            print(f"[{label}] JPEG {k.split(': ')[1]} ({where}): {n} calls, {1e3 * total / n:.3f} ms a call "
                  f"(host clock)")


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


def phase_pipeline_full_size(directory, relief_m, label, cfg=None, focal_px_tag=None, color=False, fmt="netpbm"):
    """INITIAL_PROCESSING at full image size (``cfg``, default FULL) over
    terrain with ``relief_m`` of relief, the geotags carrying
    ``focal_px_tag`` (default: the true focal); ``color`` writes colour
    files with a seeded exposure gain per image, PPM or with ``fmt="jpg"``
    JPEG at quality 95 through the port's encoder. Returns the pipeline, the
    survey's paths, positions and orientations, the state's kernel
    launches and its relax solves as ``_SolveRecorder`` records them."""
    cfg = cfg or FULL
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    t0 = time.perf_counter()
    paths, positions, quats_gt = S.write_survey(
        directory, cfg["rows"], cfg["cols"], spacing=SPACING, width=cfg["width"], height=cfg["height"],
        focal=cfg["focal"], focal_px_tag=focal_px_tag, texture=cfg["texture"], relief_amplitude=relief_m,
        relief_wavelength=RELIEF_WAVELENGTH_M, color=color,
        gains=S.survey_gains(cfg["rows"] * cfg["cols"], spread=GAIN_SPREAD) if color else None, fmt=fmt,
        device="cuda",
    )
    performance.enable_performance_counters(False)
    kind = ("JPEG" if fmt == "jpg" else "PPM" if color else "PGM") + (" (colour, exposure gains)" if color else "")
    print(f"[{label}] wrote {len(paths)} {kind} images at {cfg['width']}x{cfg['height']} "
          f"(relief {relief_m} m, focal tag {focal_px_tag or cfg['focal']}) in {time.perf_counter() - t0:.2f} s")
    _codec_line(label, "survey images")
    p = Pipeline(device="cuda")  # the pipeline's defaults: batches of 10, float64 relax problems
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    try:
        with _LinkRecorder() as rec, _SolveRecorder() as solves:
            seconds = _initial_processing(p, paths, timed=True)
    finally:
        performance.enable_performance_counters(False)
    groups = [s["groups"] for s in solves.solves]
    launches = hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] INITIAL_PROCESSING: {len(seconds)} iterate_once calls, seconds "
          f"{[round(t, 4) for t in seconds]}, total {sum(seconds):.4f} s")
    print(f"[{label}] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[{label}]   {line}")
    _codec_line(label, "load stage")
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
    return p, paths, positions, quats_gt, launches, solves.solves


def _orientation_error(p, paths, quats_gt, label, bounded=True, fail=None):
    """Orientation error against the ground truth; with ``bounded``, raise
    outside the bounds (or report through ``fail``)."""
    nodes = _by_path(p)
    err = np.asarray([_angles_deg(nodes[path].orientation, quats_gt[i]) for i, path in enumerate(paths)])
    bounds = f"bounds {MEDIAN_DEG}, {MAX_DEG}" if bounded else "not bounded"
    print(f"[{label}] orientation error vs ground truth: median {np.median(err):.4f} deg, "
          f"max {err.max():.4f} deg at image {int(np.argmax(err))} ({bounds})")
    if not np.isfinite(err).all():
        raise AssertionError(f"non-finite orientations: {err.tolist()}")
    if bounded and not (np.median(err) <= MEDIAN_DEG and err.max() <= MAX_DEG):
        message = f"cameras not recovered: {np.round(err, 3).tolist()}"
        if fail is None:
            raise AssertionError(message)
        fail(message)


def _free_cameras(built):
    """{node id: whether a measurement reaches its rotation} over the free
    cameras of a built relax problem; a free camera that only the downwards
    prior reaches has a free heading."""
    lay = built.layout
    measured = set()
    for b in built.blocks:
        if b.name == "downwards_prior":
            continue
        s = b.slots[b.weight > 0].reshape(-1).cpu().numpy()
        measured |= set(((s[(s >= lay.rot_off) & (s < lay.mesh_off)] - lay.rot_off) // 3).tolist())
    free = built.free_mask.cpu().numpy()
    return {nid: c in measured for nid, c in built.cam_index.items() if free[lay.rot_off + 3 * c]}


class _SolveRecorder(BE.SolveLog):
    """``bench_e2e.SolveLog``'s record of every relax solve, with each
    group's free cameras and whether a measurement reaches each, and each
    group's tangent dimension; with ``keep_last`` a copy of the last batched
    solve's batch as it entered the solve, its pre-solve flag, LM budget and
    result."""

    def __init__(self, keep_last=False):
        super().__init__()
        self.last = None
        self.keep_last = keep_last

    def _recording(self, name, solve):
        recording = super()._recording(name, solve)
        if not (self.keep_last and name == "solve_group_batch"):
            return recording

        def keeping(batch, pre_solve, *args, **kw):
            entry = copy.deepcopy(batch)  # before the solve moves the batch's dampings
            out = recording(batch, pre_solve, *args, **kw)
            self.last = dict(batch=entry, pre_solve=pre_solve, kw=dict(kw), out=out)
            return out

        return keeping

    def record(self, solve, batch, pre_solve, kw, out):
        solve.update(free=[_free_cameras(b) for b in batch.builts], dims=[b.layout.dim for b in batch.builts])


def _local_offset(p, positions):
    """The survey's frame minus the pipeline's local one (which starts at
    the first camera)."""
    first = _by_path(p)[sorted(_by_path(p))[0]]
    return positions[0] - np.asarray(first.position)


def _relief_error(points, positions, offset, relief_m=RELIEF_M):
    """|height - relief| of ``points`` (local frame) inside the camera
    footprint, in the survey's frame; and how many were inside."""
    v = np.asarray(points, np.float64) + offset
    lo, hi = positions[:, :2].min(0), positions[:, :2].max(0)
    inside = np.all((v[:, :2] >= lo) & (v[:, :2] <= hi), axis=1)
    truth = S.relief_height(torch.as_tensor(v[inside, :2]), relief_m, RELIEF_WAVELENGTH_M).numpy()
    return np.abs(v[inside, 2] - truth), int(inside.sum())


def _height_error(p, positions):
    """Final mesh heights against the relief at the vertices inside the
    camera footprint."""
    return _relief_error(p.surfaces[0].mesh.vertices, positions, _local_offset(p, positions))


def _surface_error(p, positions, relief_m, n=20):
    """The final mesh's surface against the relief (``relief_m`` of
    amplitude; 0: the flat ground) at an n x n grid over the camera
    footprint: the minimal mesh of a flat survey has no vertex inside it."""
    offset = _local_offset(p, positions)
    lo, hi = positions[:, :2].min(0), positions[:, :2].max(0)
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n))
    xy = np.stack([gx.ravel(), gy.ravel()], axis=1)
    z = p.surfaces[0].mesh.interpolate_z(xy - offset[:2]) + offset[2]
    truth = S.relief_height(torch.as_tensor(xy), relief_m, RELIEF_WAVELENGTH_M).numpy()
    err = np.abs(z - truth)
    return err[np.isfinite(err)], int(np.isfinite(err).sum())


def _solve_ms_per_iteration(built, linear_solver):
    _sync()
    t0 = time.perf_counter()
    params, info = LM.solve(built.params, built.blocks, built.layout, built.free_mask, linear_solver=linear_solver)
    _sync()
    seconds = time.perf_counter() - t0
    return params, info, 1e3 * seconds / max(int(info.iterations), 1)


def phase_mesh_refinement(directory):
    """The relief survey from INITIAL_PROCESSING through MESH_REFINEMENT to
    the entry of CAMERA_PARAMETER_RELAX; returns the kernel launches of the
    whole run (the link check between the two parts launches the kernel too
    and is not counted) and the state at that entry (graph, GPS index,
    camera models, surfaces), which the shared solver's phase starts from."""
    print("[mesh] cut for time: the run stops at the entry of CAMERA_PARAMETER_RELAX (the state phase 10 needs); "
          "FINAL_GLOBAL_RELAX, its plan reuse and the dense-against-CG solve run in phase 7")
    p, paths, positions, quats_gt, ip_launches, _ = phase_pipeline_full_size(directory, RELIEF_M, "mesh-ip", cfg=MESH)
    _orientation_error(p, paths, quats_gt, "mesh-ip", bounded=False)
    p._MESH_MAX_GRID_LEVELS = MESH_GRID_LEVELS
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps = []
    entry = None
    try:
        with _SolveRecorder() as rec:
            while p.get_state() != PipelineState.CAMERA_PARAMETER_RELAX:
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
                    raise AssertionError("the pipeline did not reach CAMERA_PARAMETER_RELAX in 60 passes")
    finally:
        performance.enable_performance_counters(False)
    entry = (copy.deepcopy(p.graph), p.gps_positions, dict(p.model_store), copy.deepcopy(p.surfaces))
    launches = ip_launches + hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    per_state = {}
    for st in steps:
        per_state.setdefault(st["state"], []).append(st["seconds"])
    print(f"[mesh] {len(steps)} iterate_once calls, total {sum(st['seconds'] for st in steps):.4f} s; per state "
          + ", ".join(f"{k} {len(v)} x, {sum(v):.4f} s" for k, v in per_state.items()))
    for i, st in enumerate(steps):
        solves = "; ".join(
            f"{s['groups']} group(s) dims {s['dims']} batch dim {s['T']} -> {s['route']}, LM {s['lm']}"
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
    _orientation_error(p, paths, quats_gt, "mesh")
    herr, n_inside = _height_error(p, positions)
    print(f"[mesh] mesh height error vs the relief at {n_inside} vertices inside the camera footprint: "
          f"median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if not n_inside or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        raise AssertionError(f"mesh does not follow the relief: {np.round(herr, 3).tolist()}")

    return launches, entry


def _pose_gaps(a, b, builts):
    """Largest rotation (rad) and mesh-height (m) differences between two
    solves' per-group host results, over the groups' cameras and real
    vertices."""
    rad, m = 0.0, 0.0
    for pa, pb, built in zip(a, b, builts):
        rad = max(rad, float(np.radians(_angles_deg(pa.quats, pb.quats)).max()))
        if built.v_real:
            m = max(m, float(np.abs(pa.mesh_z[: built.v_real] - pb.mesh_z[: built.v_real]).max()))
    return rad, m


def _serial_against_batched(last):
    """The last MESH_REFINEMENT pass's batch solved again on the card: by
    ``solve_groups`` (one group after another) against the pipeline's
    batched result, and by ``solve_group_batch`` once more, bit for bit."""
    batch, pre_solve, iters = last["batch"], last["pre_solve"], last["kw"].get("max_iterations")
    batched = GS.fetch_solved(last["out"][0])
    again, _ = GS.solve_group_batch(copy.deepcopy(batch), pre_solve, max_iterations=iters)
    same = all(np.array_equal(getattr(GS.fetch_solved(again), f), getattr(batched, f)) for f in FIELDS)
    _sync()
    t0 = time.perf_counter()
    serial, infos = GS.solve_groups(batch.builts, pre_solve, max_iterations=iters,
                                    init_lambda=None if batch.warm_lambda is None else batch.warm_lambda[0])
    _sync()
    serial_s = time.perf_counter() - t0
    per_group = [GS.extract_group_params(batch, batched, g) for g in range(batch.num_groups)]
    rad, m = _pose_gaps(serial, per_group, batch.builts)
    print(f"[multi] the last MESH_REFINEMENT batch solved again on the card: batched twice bit-identical: {same}; "
          f"serial solve_groups {serial_s:.3f} s, LM {[int(i.iterations) for i in infos]} against the batched "
          f"{last['out'][1].iterations.tolist()}, poses within {rad:.3e} rad and {m:.3e} m of the batched result "
          f"(bounds {SERIAL_RAD}, {SERIAL_M})")
    if not same:
        raise AssertionError("two batched solves of the same batch differ")
    if not (rad <= SERIAL_RAD and m <= SERIAL_M):
        raise AssertionError("the serial and the batched group solves disagree")


def phase_multi_group(directory):
    """Phase 7: the flat 56-image survey (``MULTI``) from images through
    INITIAL_PROCESSING, MESH_REFINEMENT and FINAL_GLOBAL_RELAX with the
    pipeline's defaults and the camera parameters skipped: every relax pass
    of more than one pose group is one batched solve. Returns the pipeline,
    the kernel launches from INITIAL_PROCESSING to the end, and the batch
    of the last MESH_REFINEMENT pass."""
    p, paths, positions, quats_gt, ip_launches, ip_solves = phase_pipeline_full_size(
        directory, 0.0, "pipeline", cfg=MULTI)
    _ip_orientation_check(p, paths, quats_gt, ip_solves)
    p.skip_camera_param_relax = True
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps, last_mr = [], None
    try:
        with _SolveRecorder(keep_last=True) as rec:
            while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
                state, n = p.get_state(), len(rec.solves)
                t0 = time.perf_counter()
                p.iterate_once()
                _sync()
                steps.append(dict(state=state, seconds=time.perf_counter() - t0, solves=rec.solves[n:],
                                  level=getattr(p, "_mesh_grid_level", None)))
                if state == PipelineState.MESH_REFINEMENT and rec.last is not None:
                    last_mr = rec.last
                if len(steps) > 40:
                    raise AssertionError("the pipeline did not reach GENERATE_THUMBNAIL in 40 passes")
    finally:
        performance.enable_performance_counters(False)
    launches = ip_launches + hamming_cuda.hamming_top2.launches
    peak = torch.cuda.max_memory_allocated()
    per_state = {}
    for st in steps:
        per_state.setdefault(st["state"], []).append(st["seconds"])
    print(f"[multi] {len(steps)} iterate_once calls after INITIAL_PROCESSING, "
          f"{sum(st['seconds'] for st in steps):.4f} s; per state "
          + ", ".join(f"{k} {len(v)} x, {sum(v):.4f} s" for k, v in per_state.items()))
    for i, st in enumerate(steps):
        solves = "; ".join(
            f"{x['kind']}: {x['groups']} group(s) in {x['lanes']} lane(s), dims {x['dims']}, T = {x['T']} -> "
            f"{x['route']}, LM per lane {x['lm']}, {x['seconds']:.3f} s" for x in st["solves"]) or "no solve"
        print(f"[multi] pass {i}: {st['state']} (level {st['level']}), {st['seconds']:.4f} s; {solves}")
    print("[multi] stage counters (host clock; seconds):")
    for line in performance.total_performance_summary().splitlines():
        print(f"[multi]   {line}")
    reuses = int(performance.get_event_count("relax plan reuses"))
    print(f"[multi] peak memory allocated {peak / 2**30:.3f} GiB; {reuses} plan reuses; Hamming kernel launches "
          f"{launches} from INITIAL_PROCESSING on")
    mr = [st for st in steps if st["state"] == PipelineState.MESH_REFINEMENT]
    bad = [(i, [(x["kind"], x["groups"]) for x in st["solves"]]) for i, st in enumerate(mr)
           if [x["kind"] for x in st["solves"]] != ["solve_group_batch"] or st["solves"][0]["groups"] < 2]
    if not mr or bad:
        raise AssertionError(f"a MESH_REFINEMENT pass was not one batched solve of two groups or more: {bad}")
    if reuses == 0:
        raise AssertionError("FINAL_GLOBAL_RELAX never reused its plan")
    _orientation_error(p, paths, quats_gt, "multi")
    herr, n_inside = _surface_error(p, positions, 0.0)
    print(f"[multi] mesh height error vs the flat ground at {n_inside} points of a grid over the camera footprint: "
          f"median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if not n_inside or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        raise AssertionError(f"mesh does not follow the ground: {np.round(herr, 3).tolist()}")
    _serial_against_batched(last_mr)
    _cholesky_against_cg(last_mr["batch"].builts[0])
    return p, launches, last_mr


def _ip_orientation_check(p, paths, quats_gt, solves):
    """Phase 7's orientations after INITIAL_PROCESSING: the median within
    MEDIAN_DEG, and every camera beyond MAX_DEG one that its last relax held
    by the downwards prior alone. Such a camera is a depth-2 halo camera of
    a later batch's relax: co-optimised, but none of its edges joins the
    problem, so its heading is free and the LM's rounding moves it. The JAX
    package does the same (ROADMAP 3b, ``tools/torch_ip_witness.py``)."""
    nodes = _by_path(p)
    err = np.asarray([_angles_deg(nodes[path].orientation, quats_gt[i]) for i, path in enumerate(paths)])
    image_of = {nid: paths.index(n.payload.path) for nid, n in p.graph.nodes()}
    last = {}
    for solve in solves:
        for group in solve["free"]:
            for nid, measured in group.items():
                last[image_of[nid]] = measured
    off = [int(i) for i in np.flatnonzero(err > MAX_DEG)]
    unexplained = [i for i in off if last.get(i, True)]
    held = sorted(i for i, measured in last.items() if not measured)
    print(f"[pipeline] orientation error vs ground truth: median {np.median(err):.4f} deg (bound {MEDIAN_DEG}), max "
          f"{err.max():.4f} deg at image {int(np.argmax(err))}; beyond {MAX_DEG} deg: "
          f"{ {i: round(float(err[i]), 4) for i in off} }; held by the downwards prior alone in their last relax: "
          f"{held}")
    if not np.isfinite(err).all():
        raise AssertionError(f"non-finite orientations: {err.tolist()}")
    if not np.median(err) <= MEDIAN_DEG or unexplained:
        raise AssertionError(f"cameras not recovered: {np.round(err, 3).tolist()}; beyond {MAX_DEG} deg with a "
                             f"measurement in their last relax: {unexplained}")


def _cholesky_against_cg(built):
    """One lane of the last MESH_REFINEMENT batch solved by the dense and by
    the matrix-free linear solver on the card, and by CG twice, bit for bit."""
    torch.cuda.reset_peak_memory_stats()
    ch, ch_info, ch_ms = _solve_ms_per_iteration(built, "cholesky")
    ch_peak = torch.cuda.max_memory_allocated()
    cg, cg_info, cg_ms = _solve_ms_per_iteration(built, "cg")
    cg2, _, cg2_ms = _solve_ms_per_iteration(built, "cg")
    ang = _angles_deg(ch.quats, cg.quats)
    dz = float((ch.mesh_z - cg.mesh_z).abs().max())
    same = all(torch.equal(getattr(cg, f), getattr(cg2, f)) for f in ("quats", "mesh_z", "focal", "radial"))
    print(f"[multi] one lane of the last MESH_REFINEMENT batch: tangent dim {built.layout.dim} ({built.layout.C} "
          f"cameras, {built.layout.V} mesh slots), blocks {[(b.name, b.slots.shape[0]) for b in built.blocks]}")
    print(f"[multi] cholesky: {int(ch_info.iterations)} LM iterations, {ch_ms:.3f} ms each, peak memory allocated "
          f"{ch_peak / 2**30:.3f} GiB; cg: {int(cg_info.iterations)} LM iterations, {cg_ms:.3f} / {cg2_ms:.3f} ms "
          f"each (two runs); cg vs cholesky: orientations {ang.max():.5f} deg, heights {dz:.5f} m apart "
          f"(bounds {CG_VS_CHOLESKY_DEG}, {CG_VS_CHOLESKY_M}); cg run twice bit-identical: {same}")
    if not same:
        raise AssertionError("two CG solves of the same problem differ")
    if not (np.isfinite(ang).all() and ang.max() <= CG_VS_CHOLESKY_DEG and dz <= CG_VS_CHOLESKY_M):
        raise AssertionError("the CG and Cholesky solves disagree")


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
    p, paths, positions, quats_gt, ip_launches, _ = phase_pipeline_full_size(
        directory, RELIEF_M, "calib-ip", focal_px_tag=FOCAL_TAG_FACTOR * true_focal, color=True, fmt="jpg")
    tag = float(p.model_store[1].focal_length_pixels)
    if len(p.model_store) != 1 or abs(tag / true_focal - FOCAL_TAG_FACTOR) > 1e-6 or p.skip_camera_param_relax:
        raise AssertionError(f"the survey's camera model is not the one wrong tag: {p.model_store}")
    from opencalibration_tpu_torch.apps import pipeline_runner

    runner_dtype = getattr(torch, pipeline_runner.parse_args([]).dtype)
    print(f"[calib] relax problems in {p.dtype} (the runner's default on the card: {runner_dtype})")
    if p.dtype != runner_dtype:
        raise AssertionError("phase 9 does not relax in the runner's dtype")
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    steps = []
    entry = None
    try:
        with _SolveRecorder() as rec, _BuildRecorder() as builds:
            while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
                state, rc = p.get_state(), p.state_run_count()
                if state == PipelineState.CAMERA_PARAMETER_RELAX and entry is None:  # kept for phase 14
                    entry = (copy.deepcopy(p.graph), copy.deepcopy(p.gps_positions), copy.deepcopy(p.model_store),
                             copy.deepcopy(p.surfaces))
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
        _fail(f"the focal length was not recovered: {focal} against {true_focal}")
    _orientation_error(p, paths, quats_gt, "calib", fail=_fail)
    herr, n_inside = _height_error(p, positions)
    print(f"[calib] mesh height error vs the relief at {n_inside} vertices inside the camera footprint: "
          f"median {np.median(herr):.4f} m, max {herr.max():.4f} m (bounds {HEIGHT_MEDIAN_M}, {HEIGHT_MAX_M})")
    if not n_inside or not (np.median(herr) <= HEIGHT_MEDIAN_M and herr.max() <= HEIGHT_MAX_M):
        _fail(f"mesh does not follow the relief: {np.round(herr, 3).tolist()}")
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
    launches += phase_ortho_tail(p, paths, positions, directory)
    return launches, dict(state=entry, positions=positions, quats=quats_gt, paths=paths, true_focal=true_focal,
                          one_group_focal=cpr[0]["focal"], one_group_lm=cpr[0]["lm"])


KEEP_GOING = False  # --keep-going: phase 9's checks report and go on, and the run fails at its end
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


def _dense_checks(p, positions, sparse, dense):
    """DENSIFY_MESH and DENSE_MESH_RELAX at full size: the counts, the
    matcher's time a pair, the dense points and the refined mesh against the
    relief."""
    st = p.dense_stats
    feats = list(st.get("features", {}).values())
    pairs = st.get("pairs", 0)
    pts = dense.get("points", np.zeros((0, 3)))
    print(f"[dense] dense features per image: {feats} (mean {np.mean(feats) if feats else 0:.1f}); {pairs} pairs "
          f"matched, gated_match {1e3 * st.get('match_seconds', 0.0) / max(pairs, 1):.3f} ms a pair (host clock, "
          f"synchronised, with the pull of idx and good); {st.get('matches', 0)} matches, {st.get('tracks', 0)} "
          f"tracks, {len(pts)} points kept after the {DS.MAX_REPROJECTION_ERROR_PIXELS} px gate; sparse track points "
          f"{sparse}")
    if sparse <= 0 or len(pts) < DENSE_OVER_SPARSE * sparse:
        _fail(f"the densified cloud ({len(pts)}) is not {DENSE_OVER_SPARSE} x the sparse tracks ({sparse})")
    offset = _local_offset(p, positions)
    if len(pts):
        err, n_in = _relief_error(pts, positions, offset)
        q = {k: float(np.percentile(err, k)) for k in (50, 90, 95, 99)} if n_in else {}
        print(f"[dense] densified points vs the relief at {n_in} points inside the camera footprint: "
              + ", ".join(f"p{k} {v:.4f} m" for k, v in q.items()) + f", max {err.max() if n_in else 0:.4f} m; "
              f"{float(np.mean(err > HEIGHT_MAX_M)) if n_in else 0:.5f} of them beyond {HEIGHT_MAX_M} m (bounds: "
              f"median {HEIGHT_MEDIAN_M} m, p{DENSE_OUTLIER_PERCENTILE} {HEIGHT_MAX_M} m)")
        if not n_in or not (q[50] <= HEIGHT_MEDIAN_M and q[DENSE_OUTLIER_PERCENTILE] <= HEIGHT_MAX_M):
            _fail("the densified points do not follow the relief")
    before, after = dense.get("mesh_before"), p.surfaces[0].mesh
    err, n_in = _relief_error(after.vertices, positions, offset)
    print(f"[dense] DENSE_MESH_RELAX: mesh {before.num_vertices} -> {after.num_vertices} vertices, "
          f"{before.num_triangles} -> {after.num_triangles} triangles; heights vs the relief at {n_in} vertices "
          f"inside the footprint: median {np.median(err):.4f} m, max {err.max():.4f} m")
    if after.num_vertices < before.num_vertices or not (np.median(err) <= HEIGHT_MEDIAN_M
                                                         and err.max() <= HEIGHT_MAX_M):
        _fail("the refined mesh lost vertices or does not follow the relief")


def _write_runner_outputs(p, out):
    """The runner's own outputs (graph JSON, GeoJSON, XYZ, PLY, camera DB,
    checkpoint) through ``apps/pipeline_runner.py::write_outputs``, read back."""
    from opencalibration_tpu_torch.apps import pipeline_runner
    from opencalibration_tpu_torch.io.serialize import deserialize_graph

    o = lambda name: os.path.join(out, name)  # noqa: E731
    args = pipeline_runner.parse_args(["-g", o("graph.geojson"), "--graph-file", o("graph.json"), "-p", o("cloud.xyz"),
                                       "-m", o("mesh.ply"), "--update-camera-db", o("camera_db.json"), "-c", o("ckpt")])
    t0 = time.perf_counter()
    pipeline_runner.write_outputs(p, args)
    took = time.perf_counter() - t0
    sizes = {n: os.path.getsize(o(n)) for n in ("graph.geojson", "graph.json", "cloud.xyz", "mesh.ply", "camera_db.json")}
    graph, models = deserialize_graph(open(o("graph.json")).read())[:2]
    db = json.load(open(o("camera_db.json")))
    print(f"[ortho] runner outputs written in {took:.2f} s: {sizes} bytes, checkpoint {sorted(os.listdir(o('ckpt')))}; "
          f"graph JSON reads back with {graph.size_nodes()} nodes, {graph.size_edges()} edges; camera DB focal "
          f"{db['cameras'][0]['focal_length_pixels']:.4f} px")
    if (min(sizes.values()) == 0 or graph.size_nodes() != p.graph.size_nodes()
            or abs(db["cameras"][0]["focal_length_pixels"] - float(p.model_store[1].focal_length_pixels)) > 1e-6):
        _fail("the runner's outputs do not read back as the pipeline holds them")


def phase_ortho_tail(p, paths, positions, directory):
    """GENERATE_THUMBNAIL to COMPLETE on the calibrated pipeline ``p`` with
    every output path set; returns the Hamming kernel's launches in it."""
    out = os.path.join(directory, "ortho_out")
    os.makedirs(out)
    p.ortho_path, p.dsm_path = os.path.join(out, "ortho.tif"), os.path.join(out, "dsm.tif")
    p.camera_id_path, p.thumbnail_path = os.path.join(out, "camera_ids.tif"), os.path.join(out, "thumbnail.png")
    p.textured_obj_prefix = os.path.join(out, "model")
    p.ortho_max_megapixels = ORTHO_MEGAPIXELS
    p.skip_dense_mesh = False
    sparse = sum(len(c) for c in p.surfaces[0].cloud)
    tiles, dense = [], {}
    p.step_callback = lambda info: tiles.append(info.tile_update) if info.tile_update else None
    performance.reset_performance_counters()
    performance.enable_performance_counters(True)
    torch.cuda.reset_peak_memory_stats()
    hamming_cuda.hamming_top2.launches = 0
    seconds, peaks, codec, last = {}, {}, {}, None
    try:
        for _ in range(12):
            state = p.get_state()
            codec[state] = _codec_counts()
            if state == PipelineState.DENSE_MESH_RELAX:
                dense["mesh_before"] = p.surfaces[0].mesh.copy()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            last = p.iterate_once()
            _sync()
            seconds[state] = time.perf_counter() - t0
            peaks[state] = torch.cuda.max_memory_allocated()
            _codec_line("ortho", state, codec[state])
            if state == PipelineState.DENSIFY_MESH:
                dense["points"] = p.surfaces[0].cloud[-1].copy() if p.dense_stats.get("points") else np.zeros((0, 3))
            if last == "DONE":
                break
    finally:
        performance.enable_performance_counters(False)
        p.step_callback = None
    launches = hamming_cuda.hamming_top2.launches
    peak = max(peaks.values())
    print("[ortho] peak memory allocated per state (GiB): "
          + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in peaks.items()))
    _dense_checks(p, positions, sparse, dense)
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
    for name in ("thumbnail.png", "model.obj", "model.mtl", "model.jpg"):
        if os.path.getsize(os.path.join(out, name)) == 0:
            _fail(f"{name} is empty")
    texture = decode_jpeg(open(os.path.join(out, "model.jpg"), "rb").read())
    if texture is None or texture.shape != img.shape[:2] + (3,):
        _fail("the textured OBJ's JPEG does not decode to the orthomosaic's size")
    del texture

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
    _write_runner_outputs(p, out)
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


def _device_lists():
    """Shards for phase 14's scale runs: on distinct cards where the host has
    several, else none (the shards then share cuda:0)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


def _sharded_ba_phase(dev):
    """(a) ``run_sharded_ba``: four shards on ``dev`` against one shard with
    the same four groups."""
    out = {}
    for n, per in ((4, 1), (1, 4)):
        _sync()
        t0 = time.perf_counter()
        mesh, p0, pf, cost = SBA.run_sharded_ba(n, groups_per_device=per, iterations=8, devices=[dev] * n)
        _sync()
        out[n] = (pf, float(cost(p0)), float(cost(pf)), time.perf_counter() - t0)
    (p4, c0, c4, s4), (p1, _, c1, s1) = out[4], out[1]
    worst = {f: float((getattr(p4, f) - getattr(p1, f)).abs().max()) for f in FIELDS if getattr(p4, f).numel()}
    focal = p4.focal.flatten().cpu().numpy()
    print(f"[multidev] (a) run_sharded_ba, 4 groups, 8 LM steps: 4 shards on {dev} {s4:.3f} s, 1 shard {s1:.3f} s; "
          f"cost {c0:.6g} -> {c4:.6g} (4 shards), {c1:.6g} (1 shard); focal {focal.tolist()} (truth 600, start 612); "
          f"4 shards against 1, largest difference per leaf {worst}")
    for f in FIELDS:
        a, b = getattr(p4, f).cpu().numpy(), getattr(p1, f).cpu().numpy()
        if not np.allclose(a, b, **SHARDED_BA_TOL):
            raise AssertionError(f"run_sharded_ba on 4 shards and on 1 differ in {f}")
    if not (np.all(focal == focal[0]) and abs(focal[0] - 600.0) <= SHARDED_BA_FOCAL_PX and c4 < 1e-2 * c0):
        raise AssertionError("run_sharded_ba did not recover the shared focal")


def _dryrun_phase(dev):
    """(b) ``dryrun_multidevice`` on two shards of ``dev``, ``entry`` there
    against the CPU."""
    _sync()
    t0 = time.perf_counter()
    DR.dryrun_multidevice([dev] * 2)
    _sync()
    dry_s = time.perf_counter() - t0
    fn, args = DR.entry(dev)
    got = [x.cpu().numpy() for x in fn(*args)]
    fn_c, args_c = DR.entry("cpu")
    want = [x.numpy() for x in fn_c(*args_c)]
    gaps = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    print(f"[multidev] (b) dryrun_multidevice([{dev}] x 2) passed its checks in {dry_s:.3f} s; entry({dev!r}): "
          f"quats, points, focal, step {[g.shape for g in got]}, card against CPU {gaps}")
    if not all(np.isfinite(g).all() for g in got):
        raise AssertionError(f"entry({dev!r}) gave non-finite values")
    # quats and points as the sharded step's bound; the focal's float32 step
    # at lam 1e-4 is ill-conditioned (tests/test_torch_sharded_ba.py)
    for name, g, w in zip(("quats", "points", "focal"), got, want):
        if not np.allclose(g, w, rtol=1e-3 if name == "focal" else 1e-5, atol=2e-4):
            raise AssertionError(f"entry on the card and on the CPU differ in {name}")


def _timed_solve(fn, batch, *args, **kw):
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(batch, *args, **kw)
    _sync()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _lanes_phase(last, devices, label):
    """(c) phase 7's last MESH_REFINEMENT batch solved on the shards
    ``devices`` against one device."""
    batch, pre_solve, iters = last["batch"], last["pre_solve"], last["kw"].get("max_iterations")
    (one, one_info), one_s, _ = _timed_solve(GS.solve_group_batch, copy.deepcopy(batch), pre_solve,
                                             max_iterations=iters)
    (sh, sh_info), sh_s, _ = _timed_solve(GS.solve_group_batch, copy.deepcopy(batch), pre_solve,
                                          max_iterations=iters, devices=devices)
    same = all(torch.equal(getattr(sh, f), getattr(one, f)) for f in FIELDS)
    gap = max(float((getattr(sh, f) - getattr(one, f)).abs().max() / getattr(one, f).abs().max().clamp_min(1.0))
              for f in FIELDS if getattr(sh, f).numel())
    print(f"[multidev] (c) phase 7's last MESH_REFINEMENT batch ({batch.num_groups} groups, T = {batch.layout.dim}) "
          f"on {label}: {sh_s:.3f} s, LM per lane {sh_info.iterations.tolist()}; on one device {one_s:.3f} s, "
          f"LM {one_info.iterations.tolist()}; bit for bit: {same}, largest difference {gap:.3e} of max(1, the leaf's "
          f"magnitude) (bound {LANES_SHARDED_REL})")
    if not (torch.equal(sh_info.iterations, one_info.iterations) and (same or gap <= LANES_SHARDED_REL)):
        raise AssertionError(f"the lanes on {label} differ from one device")


def _scale_batch(entry, dev):
    """Phase 9's state at the entry of CAMERA_PARAMETER_RELAX split into
    intrinsics groups of SCALE_GROUP_SIZE with the focal free (pass 0's
    options), built by the stage in float64 on the card."""
    graph, gps, models, surfaces = (copy.deepcopy(x) for x in entry["state"])
    group_size = ST.INTRINSICS_GROUP_SIZE
    ST.INTRINSICS_GROUP_SIZE = SCALE_GROUP_SIZE
    try:
        stage = ST.RelaxStage(device=dev, dtype=torch.float64)
        stage.init(graph, [], gps, models, relax_all=True, disable_parallelism=False,
                   options=RelaxOptions(orientation=True, ground_mesh=True, focal=True))
        stage.dispatch(graph, surfaces)
    finally:
        ST.INTRINSICS_GROUP_SIZE = group_size
    batch = stage.last_plan.batch
    if batch is None or not batch.shared_intrinsics or batch.num_groups != SCALE_SHARDS:
        raise AssertionError(f"phase 9's survey did not split into {SCALE_SHARDS} intrinsics groups")
    return batch, stage.last_plan.pre_solve


def _scale_phase(entry, devices, label, dev):
    """(d) the joint solver at full size on one shard and on the shards
    ``devices``: their agreement, the focal against the JAX package's on the
    same state, against the truth and beside phase 9's one-group pass,
    iterations, seconds, peak memory."""
    batch, pre_solve = _scale_batch(entry, dev)
    lay = batch.layout
    print(f"[multidev] (d) phase 9's {len(entry['paths'])} images at the entry of CAMERA_PARAMETER_RELAX in "
          f"{batch.num_groups} intrinsics groups of {[b.num_opt for b in batch.builts]} cameras "
          f"({[b.params.C for b in batch.builts]} with halo duplicates), layout C {lay.C} V {lay.V} M {lay.M} "
          f"(T = {lay.dim}, {LM.route(lay.dim)}), float64, pre-solve {pre_solve}")
    runs = {}
    for name, devs in (("one shard", None), (label, devices)):
        kw = {} if devs is None else dict(devices=devs)
        (solved, info), seconds, peak = _timed_solve(GS.solve_group_batch_shared, copy.deepcopy(batch), pre_solve,
                                                     max_iterations=LM.DEFAULT_MAX_ITERATIONS, **kw)
        host = GS.fetch_solved(solved)
        focal = float(host.focal[0, 0])
        runs[name] = (host, info, focal)
        print(f"[multidev] (d) {name}: {int(info.iterations)} LM iterations in {seconds:.3f} s, peak memory "
              f"{peak / 2**30:.3f} GiB, cost {float(info.initial_cost):.6g} -> {float(info.final_cost):.6g}, focal "
              f"{float(batch.params.focal[0, 0]):.4f} -> {focal:.4f} px "
              f"({100 * abs(focal / entry['true_focal'] - 1):.4f} % off the truth)")
        for leaf in ("mesh_z", "focal"):
            v = getattr(host, leaf)
            if not all(np.array_equal(v[0], v[g]) for g in range(1, batch.num_groups)):
                raise AssertionError(f"{name}: the groups' copies of {leaf} differ")
    (h1, i1, f1), (hd, idd, fd) = runs["one shard"], runs[label]
    worst = 0.0
    for f in FIELDS:
        a, b = getattr(hd, f), getattr(h1, f)
        if a.size:
            worst = max(worst, float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)))
    rel = abs(f1 / entry["true_focal"] - 1.0)
    ref = max(abs(f / SCALE_REFERENCE_FOCAL - 1.0) for f in (f1, fd))
    print(f"[multidev] (d) {label} against one shard: largest leaf difference {worst:.3e} relative (bound "
          f"{SCALE_REL}), iterations {int(idd.iterations)} / {int(i1.iterations)}; focal {f1:.4f} px, "
          f"{100 * rel:.4f} % off the true {entry['true_focal']} (not bounded: see SCALE_REFERENCE_FOCAL), "
          f"{ref:.3e} relative from the JAX package's {SCALE_REFERENCE_FOCAL} px on this state (bound "
          f"{SCALE_REFERENCE_REL}); phase 9's one group in its pass 0: {entry['one_group_focal']:.4f} px "
          f"({entry['one_group_lm']} LM iterations)")
    if not (worst <= SCALE_REL and int(idd.iterations) == int(i1.iterations)):
        raise AssertionError(f"the joint solve on {label} differs from one shard")
    if not ref <= SCALE_REFERENCE_REL:
        raise AssertionError(f"the joint solve of three groups parts from the JAX package's: {f1}, {fd}")


def phase_multi_device(multi_last, calib_entry, dev="cuda:0"):
    """Phase 14: the multi-device paths on the card, their shards on ``dev``
    (and again on distinct cards where the host has several)."""
    t0 = time.perf_counter()
    hamming_cuda.hamming_top2.launches = 0
    _sharded_ba_phase(dev)
    _dryrun_phase(dev)
    if multi_last is None or calib_entry is None:
        raise AssertionError("phase 14 needs phases 7 and 9 (run them with it)")
    _lanes_phase(multi_last, [dev] * 2, f"[{dev}] x 2")
    _scale_phase(calib_entry, [dev] * SCALE_SHARDS, f"[{dev}] x {SCALE_SHARDS}", dev)
    distinct = _device_lists()
    if distinct is None:
        print(f"[multidev] one card on this host: every shard above shared {dev} (no run on distinct cards)")
    else:
        _lanes_phase(multi_last, distinct[:2], f"{[str(d) for d in distinct[:2]]}")
        _scale_phase(calib_entry, distinct[:SCALE_SHARDS], f"{[str(d) for d in distinct[:SCALE_SHARDS]]}", dev)
    launches = hamming_cuda.hamming_top2.launches
    print(f"[multidev] phase 14: {time.perf_counter() - t0:.1f} s; Hamming kernel launches {launches} (no link "
          f"on these paths)")
    return launches


def _read_pgm(path):
    """A binary 8-bit PGM as written by ``testing/survey.py``: [H, W] uint8."""
    data = open(path, "rb").read()
    magic, w, h, maxval, rest = data.split(maxsplit=4)
    if magic != b"P5" or maxval != b"255":
        raise ValueError(f"{path} is not an 8-bit binary PGM")
    return np.frombuffer(rest, np.uint8)[: int(w) * int(h)].reshape(int(h), int(w))


def _fed_entry(images):
    """``extract_features(diffusion="fed")`` on a crop of two survey images,
    card against CPU, then at full size on the card alone."""
    h, w = FED_CROP_HW
    crop = torch.as_tensor(np.ascontiguousarray(images[:, :h, :w]))
    feats = {dev: F.extract_features(crop.to(dev), max_features=FED_MAX_FEATURES, diffusion="fed")
             for dev in ("cuda", "cpu")}
    got, want = ({k: v.cpu().numpy() for k, v in feats[d].items()} for d in ("cuda", "cpu"))
    counts = (got["valid"].sum(1).tolist(), want["valid"].sum(1).tolist())
    v = want["valid"] & got["valid"]
    close = (np.abs(got["xy"] - want["xy"]) <= FED_XY_PX).all(-1) & v
    equal = (got["xy"] == want["xy"]).all(-1) & v
    rows = (got["descriptors"][equal] == want["descriptors"][equal]).all(-1)
    bits = np.unpackbits(got["descriptors"][equal].view(np.uint8)) == np.unpackbits(
        want["descriptors"][equal].view(np.uint8))
    share = close.sum() / max(want["valid"].sum(), 1)
    print(f"[entry] extract_features(diffusion='fed') on a {w}x{h} crop of two survey images: keypoints "
          f"{counts[0]} on the card, {counts[1]} on the CPU; {share:.4f} within {FED_XY_PX} px (bound "
          f"{FED_XY_SHARE}); of the {int(equal.sum())} equal keypoints {int(rows.sum())} have equal descriptors, "
          f"{bits.mean():.5f} of the bits equal (bound {FED_BIT_SHARE})")
    if counts[0] != counts[1] or share < FED_XY_SHARE or bits.mean() < FED_BIT_SHARE or not want["valid"].sum():
        raise AssertionError("the fed extraction differs between the card and the CPU")
    full = torch.as_tensor(images).to("cuda")
    F.extract_features(full[:1, :64, :64], max_features=64, diffusion="fed")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    out = F.extract_features(full, max_features=FULL["max_features"], diffusion="fed")
    _sync()
    print(f"[entry] fed extraction at {full.shape[2]}x{full.shape[1]} on the card: {full.shape[0]} images in "
          f"{time.perf_counter() - t0:.3f} s, keypoints {out['valid'].sum(1).tolist()}, peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def _epipolar_scene(n, seed, planar=0.2, outliers=0.15):
    """Calibrated correspondences [n, 3] of two views 0.5 m apart turned by
    0.15 rad: a ``planar`` share of the points on one plane, the rest at
    depths 5-15, 1e-4 of noise, an ``outliers`` share replaced at random.
    Returns them, the true essential matrix (x2^T E x1 = 0) and the mask of
    the true correspondences."""
    rng = np.random.default_rng(seed)
    c, s_ = np.cos(0.15), np.sin(0.15)
    R2 = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
    t2 = np.array([0.5, 0.0, 0.0])
    X = np.column_stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(5, 15, n)])
    X[: int(n * planar), 2] = 10.0
    x1 = X / X[:, 2:]
    x2 = (X - t2) @ R2.T
    x2 = x2 / x2[:, 2:]
    x1[:, :2] += rng.normal(scale=1e-4, size=(n, 2))
    x2[:, :2] += rng.normal(scale=1e-4, size=(n, 2))
    out = rng.random(n) < outliers
    x2[out, :2] = rng.uniform(-1, 1, (out.sum(), 2))
    t = -R2 @ t2
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R2
    return x1, x2, E, ~out


def _sign_gap(a, b):
    """Largest entry of the difference of two 3 x 3 models scaled to unit
    norm, the nearer of the two signs."""
    a, b = (np.asarray(m, np.float64).reshape(-1) for m in (a, b))
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def _ransac_both(x1, x2, model_type):
    """``ransac`` of one scene on the card and on the CPU from the same
    uniforms: {device: (result on the CPU, seconds)}."""
    n = len(x1)
    u = R.default_uniforms(RANSAC_K, R._MODELS[model_type].min_points, R.DEFAULT_SEED, "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        args = [torch.as_tensor(a, device=dev) for a in (x1, x2, np.zeros(n), np.ones(n, bool))]
        t0 = time.perf_counter()
        res = R.ransac(*args, model_type, num_hypotheses=RANSAC_K, uniforms=u.to(dev))
        if dev == "cuda":
            _sync()
        out[dev] = (R.RansacResult(*(v.cpu() for v in res)), time.perf_counter() - t0)
    return out


def _ransac_line(model_type, label, out):
    """Print the card against the CPU; returns (models' gap up to sign,
    share of equal inlier flags, relative score gap)."""
    (a, ta), (b, tb) = out["cuda"], out["cpu"]
    gap = _sign_gap(a.model, b.model)
    same = float((a.inliers == b.inliers).double().mean())
    score_rel = abs(float(a.score) - float(b.score)) / max(float(b.score), 1e-30)
    print(f"[entry] ransac('{model_type}'), {label}, {len(a.inliers)} correspondences, {RANSAC_K} hypotheses: card "
          f"{ta:.3f} s, CPU {tb:.3f} s; models {gap:.2e} apart up to sign; inlier flags {same:.5f} equal; "
          f"{int(a.inliers.sum())} / {int(b.inliers.sum())} inliers; scores {float(a.score):.6f} / "
          f"{float(b.score):.6f} ({score_rel:.2e} apart)")
    return gap, same, score_rel


def _ransac_entry():
    """``ransac`` for the epipolar models on the card against the CPU, on the
    same uniforms. The fundamental matrix (8 points) is held to the CPU on
    two scenes with outliers. An essential hypothesis (5 points) is a vector
    of a 4-dimensional null space that the eigen solver picks, differently
    on the card and on the CPU, so the essential RANSAC is held to the CPU on
    a scene without outliers, and to the truth (the precision of its
    inliers) on the scenes with outliers. Then DEGENSAC on both devices from
    one plane-degenerate fundamental matrix, where it must fire."""
    n = RANSAC_N
    for seed in RANSAC_SEEDS:
        x1, x2, _, true = _epipolar_scene(n, seed)
        gap, same, score_rel = _ransac_line("fundamental", f"scene {seed}", _ransac_both(x1, x2, "fundamental"))
        if not (gap <= RANSAC_MODEL_REL and same >= RANSAC_INLIER_SHARE and score_rel <= RANSAC_SCORE_REL):
            raise AssertionError(f"ransac('fundamental') differs between the card and the CPU on scene {seed}")
        out = _ransac_both(x1, x2, "essential")
        _ransac_line("essential", f"scene {seed}", out)
        for dev, (res, _) in out.items():
            inl = res.inliers.numpy()
            precision = float((inl & true).sum() / max(inl.sum(), 1))
            recall = float((inl & true).sum() / true.sum())
            print(f"[entry]   essential on the {dev}: precision {precision:.4f} (bound {ESSENTIAL_PRECISION}), "
                  f"recall {recall:.4f} of the scene's true correspondences")
            if not precision >= ESSENTIAL_PRECISION:
                raise AssertionError(f"ransac('essential') on the {dev} keeps outliers on scene {seed}")
    x1, x2, E, _ = _epipolar_scene(n, RANSAC_SEEDS[0], outliers=0.0)
    out = _ransac_both(x1, x2, "essential")
    gap, same, score_rel = _ransac_line("essential", f"scene {RANSAC_SEEDS[0]} without outliers", out)
    truth = {dev: _sign_gap(res.model, E) for dev, (res, _) in out.items()}
    print(f"[entry]   models against the true essential matrix: card {truth['cuda']:.2e}, CPU {truth['cpu']:.2e} "
          f"(bound {ESSENTIAL_TRUTH})")
    if not (same >= RANSAC_INLIER_SHARE and score_rel <= RANSAC_SCORE_REL and max(truth.values()) <= ESSENTIAL_TRUTH):
        raise AssertionError("ransac('essential') differs between the card and the CPU on the scene without outliers")
    # DEGENSAC from a fundamental matrix fitted to the plane's points alone,
    # one matrix for both devices: it explains the plane and little else
    x1, x2, _, _ = _epipolar_scene(n, DEGENSAC_SEED, planar=DEGENSAC_PLANAR)
    plane = np.zeros(n)
    plane[: int(n * DEGENSAC_PLANAR)] = 1.0
    F0 = M.fundamental_fit_weighted(*(torch.as_tensor(a) for a in (x1[:, :2], x2[:, :2], plane)))
    out = {}
    for dev in ("cuda", "cpu"):
        p1, p2, valid = (torch.as_tensor(a, device=dev) for a in (x1[:, :2], x2[:, :2], np.ones(n, bool)))
        Fd = F0.to(dev)
        per, inl = R._msac_score(M.epipolar_error(Fd, p1, p2), M.FUNDAMENTAL_INLIER_THRESHOLD, valid)
        out[dev] = [v.cpu() for v in R._fundamental_degensac(Fd, per.sum(), inl, p1, p2, valid,
                                                             M.FUNDAMENTAL_INLIER_THRESHOLD)]
        if dev == "cpu":
            start = int(inl.sum())
    (fa, _, ia, ua), (fb, _, ib, ub) = out["cuda"], out["cpu"]
    gap = _sign_gap(fa, fb)
    same = float((ia == ib).double().mean())
    print(f"[entry] DEGENSAC from a plane-degenerate fundamental matrix ({DEGENSAC_PLANAR:.0%} of the points on one "
          f"plane, {start} inliers): used on the card {bool(ua)}, on the CPU {bool(ub)}; {int(ia.sum())} / "
          f"{int(ib.sum())} inliers after it, flags {same:.5f} equal (bound {RANSAC_INLIER_SHARE}); models {gap:.2e} "
          f"apart up to sign (bound {RANSAC_MODEL_REL})")
    if not (bool(ua) and bool(ub)):
        raise AssertionError("DEGENSAC did not replace a plane-degenerate fundamental matrix")
    if not (same >= RANSAC_INLIER_SHARE and gap <= RANSAC_MODEL_REL):
        raise AssertionError("DEGENSAC differs between the card and the CPU")


def _points_entry():
    """``relax`` with ``points_3d`` of phase 6's 2 x 3 survey on the card
    against the CPU, from one INITIAL_PROCESSING state: by the problem's own
    route (CG at its size) and by the dense route (Cholesky), whose exact
    steps hold the two devices tightly together."""
    from opencalibration_tpu_torch.relax.problem_builder import apply_solution
    from opencalibration_tpu_torch.relax.relax import build_problem
    from opencalibration_tpu_torch.types.graph import NodePose

    with tempfile.TemporaryDirectory() as d:
        paths, _, _ = S.write_survey(d, SMALL["rows"], SMALL["cols"], device="cuda")
        ip = Pipeline(batch_size=3, device="cuda")
        _initial_processing(ip, paths)
    graph, models = ip.graph, ip.model_store
    ids = sorted(graph.node_ids())
    out, dense = {}, {}
    for dev in ("cuda", "cpu"):
        poses = [NodePose(node_id=i, orientation=np.array(graph.get_node(i).payload.orientation, np.float64),
                          position=np.array(graph.get_node(i).payload.position, np.float64)) for i in ids]
        t0 = time.perf_counter()
        built, pre = build_problem(graph, poses, dict(models), sorted(graph.edge_ids()),
                                   RelaxOptions(orientation=True, points_3d=True), dtype=torch.float64, device=dev)
        batch = GS.build_group_batch([built])
        solved, info = GS.solve_group_batch(batch, pre)
        surface = apply_solution(built, GS.extract_group_params(batch, GS.fetch_solved(solved), 0), poses)
        out[dev] = (poses, surface.cloud[0], int(info.iterations[0]), time.perf_counter() - t0, built.layout)
        t0 = time.perf_counter()
        p = built.params
        if pre:
            p, _ = LM.solve(p, built.blocks, built.layout, built.surface_free_mask, linear_solver="cholesky",
                            max_iterations=POINTS_DENSE_ITERATIONS)
        p, info = LM.solve(p, built.blocks, built.layout, built.free_mask, linear_solver="cholesky",
                           max_iterations=POINTS_DENSE_ITERATIONS)
        dense[dev] = (p.quats.cpu(), p.points.cpu(), int(info.iterations), time.perf_counter() - t0)
    (pa, ca, ia, sa, lay), (pb, cb, ib, sb, _) = out["cuda"], out["cpu"]
    ang = max(float(_angles_deg(x.orientation, y.orientation)) for x, y in zip(pa, pb))
    dm = float(np.abs(ca - cb).max()) if ca.shape == cb.shape else float("inf")
    print(f"[entry] relax(points_3d) of the 2x3 survey: {lay.P} points, T = {lay.dim} -> {LM.route(lay.dim)}; card "
          f"{ia} LM iterations in {sa:.3f} s, CPU {ib} in {sb:.3f} s; orientations {ang:.2e} deg apart (bound "
          f"{POINTS_DEG}), points {dm:.2e} m apart (bound {POINTS_M})")
    (qa, xa, ja, ta), (qb, xb, jb, tb) = dense["cuda"], dense["cpu"]
    dang = float(_angles_deg(qa, qb).max())
    ddm = float((xa - xb).abs().max())
    print(f"[entry] the same problem by the dense route, cut for time at {POINTS_DENSE_ITERATIONS} LM iterations: "
          f"card {ja} LM iterations in {ta:.3f} s, CPU {jb} in "
          f"{tb:.3f} s; orientations {dang:.2e} deg apart (bound {POINTS_DENSE_DEG}), points {ddm:.2e} m apart "
          f"(bound {POINTS_DENSE_M})")
    if not (ang <= POINTS_DEG and dm <= POINTS_M):
        raise AssertionError("the points relax differs between the card and the CPU")
    if not (dang <= POINTS_DENSE_DEG and ddm <= POINTS_DENSE_M):
        raise AssertionError("the points relax by the dense route differs between the card and the CPU")


def _interchange_entry(p):
    """``save_reference_graph`` of a pipeline's graph, then
    ``load_reference_graph``, compared."""
    from opencalibration_tpu_torch.io.interchange import load_reference_graph, save_reference_graph

    t0 = time.perf_counter()
    text = save_reference_graph(p.graph, p.model_store)
    saved = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph, models = load_reference_graph(text)
    loaded = time.perf_counter() - t0
    same_ids = (sorted(graph.node_ids()) == sorted(p.graph.node_ids())
                and sorted(e for e, _ in graph.edges()) == sorted(e for e, _ in p.graph.edges()))
    pose_gap, desc_ok = 0.0, True
    for nid in p.graph.node_ids():
        a, b = p.graph.get_node(nid).payload, graph.get_node(nid).payload
        pose_gap = max(pose_gap, float(np.abs(np.asarray(a.orientation) - b.orientation).max()),
                       float(np.abs(np.asarray(a.position) - b.position).max()))
        n = int(a.features.valid.sum())
        desc_ok &= np.array_equal(np.asarray(a.features.descriptors[a.features.valid], np.uint32),
                                  np.asarray(b.features.descriptors[:n], np.uint32))
    print(f"[entry] save_reference_graph / load_reference_graph of {p.graph.size_nodes()} nodes and "
          f"{p.graph.size_edges()} edges: {len(text) / 2**20:.2f} MiB, saved in {saved:.3f} s, loaded in {loaded:.3f} "
          f"s; same node and edge ids {same_ids}, descriptors bit for bit {desc_ok}, poses within {pose_gap:.1e} "
          f"(bound {INTERCHANGE_POSE}); camera models {sorted(models)}")
    if not (same_ids and desc_ok and pose_gap <= INTERCHANGE_POSE and sorted(models) == sorted(p.model_store)):
        raise AssertionError("the reference-format graph does not read back")


def phase_entry_points(images, pipeline):
    """Phase 13: the library entry points that no pipeline state calls, on
    the card against the CPU: ``fed`` extraction, epipolar RANSAC with
    DEGENSAC, the points relax, the reference-graph interchange of
    ``pipeline``'s graph."""
    t0 = time.perf_counter()
    _fed_entry(images)
    _ransac_entry()
    _points_entry()
    _interchange_entry(pipeline)
    print(f"[entry] {time.perf_counter() - t0:.2f} s")


RUNNER_ARTIFACTS = ["graph.geojson", "graph.json", "cloud.xyz", "mesh.ply", "ortho.tif", "dsm.tif", "camera_ids.tif",
                    "textured.obj", "textured.mtl", "textured.jpg", "thumb.png", "camera_db.json",
                    os.path.join("ckpt", "metadata.json"), os.path.join("ckpt", "graph.json")]
_RUNNER_CODE = """
import json, runpy, sys
for name in ("jax", "opencalibration_tpu", "cv2", "PIL"):
    sys.modules[name] = None  # any import of it raises
from opencalibration_tpu_torch.ops import hamming_cuda
sys.argv = ["pipeline_runner"] + json.loads(sys.argv[1])
hamming_cuda.hamming_top2.launches = 0
rc = 0
try:
    runpy.run_module("opencalibration_tpu_torch.apps.pipeline_runner", run_name="__main__")
except SystemExit as e:
    rc = e.code
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu", "cv2", "PIL")
                and sys.modules[m])
print(json.dumps(dict(rc=rc, launches=hamming_cuda.hamming_top2.launches, loaded=loaded)))
"""


def phase_runner():
    """The CLI end to end on the card: ``python -m
    opencalibration_tpu_torch.apps.pipeline_runner`` in a subprocess where
    jax, the JAX package, cv2 and PIL cannot be imported, on a flat 2 x 3
    JPEG survey at 320 x 240 (cut for time: over the relief MESH_REFINEMENT
    took 17 passes; phase 9 runs the relief), every flag of the JAX package's
    tests/test_cli.py and ``--dense-mesh 1``; then its graph JSON and
    checkpoint read back and ``extract_camera_db`` run on the checkpoint.
    Returns the kernel launches the runner's process counted."""
    from opencalibration_tpu_torch.apps import extract_camera_db
    from opencalibration_tpu_torch.io.serialize import deserialize_graph

    with tempfile.TemporaryDirectory() as d:
        images, out = os.path.join(d, "images"), os.path.join(d, "out")
        os.makedirs(images)
        os.makedirs(out)
        t0 = time.perf_counter()
        paths, _, _ = S.write_survey(images, SMALL["rows"], SMALL["cols"], spacing=SPACING, width=SMALL["width"],
                                     height=SMALL["height"], focal=SMALL["focal"], texture=SMALL["texture"], color=True,
                                     gains=S.survey_gains(SMALL["rows"] * SMALL["cols"], spread=GAIN_SPREAD),
                                     fmt="jpg", device="cuda")
        o = lambda name: os.path.join(out, name)  # noqa: E731
        argv = ["-i", images, "--device", "cuda", "--batch-size", "4", "--camera-param-relax", "0",
                "--final-relax", "1", "-c", o("ckpt"), "-g", o("graph.geojson"), "--graph-file", o("graph.json"),
                "-p", o("cloud.xyz"), "-m", o("mesh.ply"), "-o", o("ortho.tif"), "--dsm-file", o("dsm.tif"),
                "--camera-id-file", o("camera_ids.tif"), "-x", o("textured.obj"), "-t", o("thumb.png"),
                "--update-camera-db", o("camera_db.json"), "--dense-mesh", "1", "-d", "4",
                "--log-file", o("log.txt"), "--perf"]
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _RUNNER_CODE, json.dumps(argv)], capture_output=True, text=True,
                           timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
        took = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"the runner's process failed ({r.returncode}): {r.stdout[-3000:]}{r.stderr[-3000:]}")
        result = json.loads(r.stdout.strip().splitlines()[-1])
        log = open(o("log.txt")).read()
        print(f"[runner] {len(paths)} JPEG images at {SMALL['width']}x{SMALL['height']} written in {written:.2f} s; "
              f"python -m opencalibration_tpu_torch.apps.pipeline_runner --device cuda ... --dense-mesh 1: exit "
              f"{result['rc']} in {took:.2f} s (process start included); Hamming kernel launches {result['launches']}; "
              f"jax / opencalibration_tpu / cv2 / PIL loaded: {result['loaded'] or 'none'}")
        for line in r.stdout.splitlines():
            if line.startswith("state "):
                print(f"[runner]   {line}")
        missing = [n for n in RUNNER_ARTIFACTS if not os.path.exists(o(n)) or os.path.getsize(o(n)) == 0]
        print(f"[runner] {len(RUNNER_ARTIFACTS) - len(missing)} of {len(RUNNER_ARTIFACTS)} artifacts written and "
              f"non-empty" + (f"; missing or empty: {missing}" if missing else ""))
        if result["rc"] != 0 or result["loaded"] or missing or result["launches"] == 0:
            raise AssertionError(f"the runner did not write its outputs on its own: {result}, missing {missing}")
        if "DENSIFY_MESH" not in log or "DENSE_MESH_RELAX" not in log:
            raise AssertionError("the runner's log shows no dense-mesh state")
        graph, models = deserialize_graph(open(o("graph.json")).read())[:2]
        q = Pipeline(device="cuda")
        if not q.load_checkpoint(o("ckpt")) or q.get_state() != PipelineState.COMPLETE:
            raise AssertionError("the runner's checkpoint does not load at COMPLETE")
        if graph.size_nodes() != len(paths) or q.graph.size_nodes() != len(paths):
            raise AssertionError(f"the graph JSON holds {graph.size_nodes()} nodes, the checkpoint "
                                 f"{q.graph.size_nodes()}, of {len(paths)} images")
        db_path = o("extracted_db.json")
        rc = extract_camera_db.main(["-c", o("ckpt"), "-o", db_path, "--device", "cuda"])
        db = json.load(open(db_path))
        focal = float(q.model_store[1].focal_length_pixels)
        print(f"[runner] graph JSON: {graph.size_nodes()} nodes, {graph.size_edges()} edges; checkpoint loaded at "
              f"{q.get_state()}; extract_camera_db exit {rc}, focal {db['cameras'][0]['focal_length_pixels']:.4f} px "
              f"(checkpoint {focal:.4f} px); {sum(1 for _ in open(o('cloud.xyz')))} cloud points")
        if rc != 0 or abs(db["cameras"][0]["focal_length_pixels"] - focal) > 1e-6:
            raise AssertionError("extract_camera_db did not write the calibrated focal")
    return result["launches"]


def _bench_bounds(result, label):
    """The bench bounds on one result dict of ``bench_e2e.run_config``."""
    print(f"[bench] {label}: {result['n_images']} images, {result['wall_s']} s, {result['images_per_sec_e2e']} "
          f"images/s, {result['lm_iterations']} LM iterations, median pose error {result['median_pose_err_m']} m "
          f"(bound {BENCH_POSE_M}), focal error {result.get('focal_err_px')} px (bound {BENCH_FOCAL_PX}), "
          f"final state {result['final_state']}, Hamming kernel launches {result['hamming_launches']}")
    if result["final_state"] != PipelineState.COMPLETE:
        raise AssertionError(f"{label} stopped at {result['final_state']}")
    if not (result["median_pose_err_m"] <= BENCH_POSE_M and result["focal_err_px"] <= BENCH_FOCAL_PX):
        raise AssertionError(f"{label} misses the bounds: {result}")
    if result["hamming_launches"] == 0:
        raise AssertionError(f"{label} never launched the Hamming kernel")


def _bench_line(run):
    """Wait for the bench's process of phase 15 (a) and check its line."""
    proc, out, err, t0 = run
    try:
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    took = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"the bench failed ({proc.returncode}): {stdout[-3000:]}{stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    line = json.loads(lines[-1])
    print(f"[bench] (a) python -m opencalibration_tpu_torch.bench.bench (BENCH_SKIP_CPU_E2E=1): exit 0 in "
          f"{took:.1f} s (process start included, beside (b), (c) and phase 16), {len(lines)} line(s) on its "
          "standard output; the last:")
    print(f"[bench]   {lines[-1]}")
    if not line["value"] > 0 or line["e2e"]["cpu_node_1core"] is not None:
        raise AssertionError(f"the bench line is malformed: {line}")
    for leg in ("cold", "warm"):
        e2e = line["e2e"][leg]
        _bench_bounds(e2e, f"(a) 24-image leg, {leg}")
        sizes = e2e.get("ortho_artifacts", {})
        if any(sizes.get(name, 0) <= 0 for name in BENCH_GEOTIFFS):
            raise AssertionError(f"the {leg} leg did not write the three GeoTIFFs: {sizes}")
    print(f"[bench] (a) step {line['step_s']:.4f} s ({line['compute_kernel']['device_ips']} images/s, "
          f"{line['compute_kernel']['vs_cpu']}x the CPU), value {line['value']} images/s; GeoTIFFs "
          f"{line['e2e']['warm']['ortho_artifacts']}; on {line['device']}")
    return sum(line["hamming_launches"].values())


def start_bench():
    """Phase 15 (a): the bench script in its own process, started before (b)
    and (c) and run beside them on the same card, for the script's time (so
    neither's seconds are for comparison). Returns (process, stdout file,
    stderr file, start time)."""
    env = {k: v for k, v in os.environ.items() if k not in ("BENCH_E2E_ORTHO", "BENCH_E2E_CHECKPOINT")}
    env["BENCH_SKIP_CPU_E2E"] = "1"
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "opencalibration_tpu_torch.bench.bench"], stdout=out,
                            stderr=err, text=True, cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
    CHILDREN.append(proc)
    return proc, out, err, time.perf_counter()


def phase_bench():
    """Phase 15 (b) the 104-image survey in batches of 16 cut after five
    INITIAL_PROCESSING iterates; (c) ``run_config`` resumed from that cut to
    COMPLETE. Returns the Hamming kernel's launches of (c)."""
    saved = {k: os.environ.pop(k, None) for k in ("BENCH_E2E_ORTHO", "BENCH_E2E_CHECKPOINT")}
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            paths, _, _, gen_s = BE.bench_survey(BENCH_IMAGES, device="cuda")
            p = BE.make_pipeline(BENCH_CUT_BATCH, device="cuda")
            p.add(paths)
            for _ in range(BENCH_CUT_ITERATES):
                p.iterate_once()
            if p.get_state() != PipelineState.INITIAL_PROCESSING:
                raise AssertionError(f"the cut is not inside INITIAL_PROCESSING: {p.get_state()}")
            if not p.save_checkpoint(ckpt):
                raise AssertionError("save_checkpoint failed")
            BE._save_ip_sidecar(p, ckpt)
            side = json.load(open(os.path.join(ckpt, "ip_sidecar.json")))
            print(f"[bench] (b) {len(paths)} images (survey {gen_s:.2f} s) in batches of {BENCH_CUT_BATCH}, cut "
                  f"after {BENCH_CUT_ITERATES} iterates of INITIAL_PROCESSING: {side['graph_nodes']} nodes, "
                  f"{side['graph_edges']} edges, {len(side['pending'])} loaded and {len(side['linked'])} linked "
                  f"(the linked batch and the nodes its edges reach) in flight, {len(side['remaining'])} queued; "
                  f"{time.perf_counter() - t0:.1f} s")
            del p

            os.environ["BENCH_E2E_CHECKPOINT"] = ckpt
            hamming_cuda.hamming_top2.launches = 0
            result = BE.run_config(BENCH_IMAGES, batch_size=BENCH_CUT_BATCH)
            resume_launches = hamming_cuda.hamming_top2.launches
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    print(f"[bench] (c) run_config({BENCH_IMAGES}, batch_size={BENCH_CUT_BATCH}) with BENCH_E2E_CHECKPOINT: resumed "
          f"at {result['resumed_at']}, {result['resume_kept_nodes']} nodes kept by the roll-back; at the end "
          f"{result['n_nodes']} nodes, {result['n_survey_paths_in_graph']} of the survey's paths; peak "
          f"{result['peak_memory_gib']:.3f} GiB; on {result['device']}")
    for state, seconds in result["state_s"].items():
        solves = result["solves"].get(state)
        print(f"[bench]   {state}: {seconds:.4f} s" + (
            f"; {solves['solves']} solves, up to {solves['max_groups']} groups, lanes {solves['lanes']}, T "
            f"{solves['T']}, routes {solves['routes']}, {solves['lm_iterations']} LM iterations, "
            f"{solves['seconds']:.3f} s solving" if solves else "; no relax solve"))
    print(f"[bench] (c) result: {json.dumps(result)}")
    _bench_bounds(result, f"(c) {BENCH_IMAGES}-image run, resumed")
    if result["resumed_at"] != PipelineState.INITIAL_PROCESSING:
        raise AssertionError(f"the run did not resume inside INITIAL_PROCESSING: {result['resumed_at']}")
    if not 0 < result["resume_kept_nodes"] < side["graph_nodes"]:
        raise AssertionError(f"the roll-back is not partial: {result['resume_kept_nodes']} of {side['graph_nodes']} "
                             "nodes kept")
    if not result["n_nodes"] == result["n_survey_paths_in_graph"] == BENCH_IMAGES:
        raise AssertionError(f"the resumed graph does not hold each of the {BENCH_IMAGES} images once: "
                             f"{result['n_nodes']} nodes, {result['n_survey_paths_in_graph']} survey paths")
    mesh = result["solves"].get(PipelineState.MESH_REFINEMENT, {})
    if mesh.get("max_groups", 0) < BENCH_MIN_POSE_GROUPS:
        raise AssertionError(f"no MESH_REFINEMENT solve of {BENCH_MIN_POSE_GROUPS} pose groups or more: {mesh}")
    if resume_launches == 0:
        raise AssertionError("the resumed run never launched the Hamming kernel")
    return resume_launches


def start_twins(directory):
    """Phase 16's processes, all started at once: the five remaining twins
    (``TWIN_RUNS``; bench_overlap_ab one process a leg, each saving its
    checkpoint to ``directory/<leg>`` at the end of INITIAL_PROCESSING).
    Returns {label: (process, stdout file, stderr file, start time)}."""
    BE.bench_survey(BENCH_IMAGES, device="cuda")  # written once, before the two legs read it
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for label, (twin, *args) in TWIN_RUNS.items():
        env = {k: v for k, v in os.environ.items() if k not in ("BENCH_E2E_ORTHO", "BENCH_E2E_CHECKPOINT")}
        if twin == "bench_overlap_ab":
            env["BENCH_E2E_CHECKPOINT"] = os.path.join(directory, label)
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([sys.executable, "-m", f"opencalibration_tpu_torch.bench.{twin}", *args], stdout=out,
                                stderr=err, text=True, cwd=root, env=env)
        CHILDREN.append(proc)
        runs[label] = (proc, out, err, time.perf_counter())
    print(f"[twins] started {len(runs)} processes: {', '.join(runs)}")
    return runs


def _twin_lines(label, run, smi):
    """Wait for one twin's process: exit 0, the device line first. Returns
    the lines after it."""
    proc, out, err, t0 = run
    try:
        proc.wait(timeout=max(1.0, TWIN_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise AssertionError(f"twin {label} failed ({proc.returncode}): {stdout[-3000:]}{stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    print(f"[twins] {label}: exit 0, {time.perf_counter() - t0:.1f} s from its start (beside the others)")
    for line in lines:
        print(f"[twins]   {line}")
    if lines[0] != smi:
        raise AssertionError(f"twin {label}'s first line is not the device: {lines[0]!r}")
    return lines[1:]


def _fraction(label, name, value):
    if not 0.0 < value <= TWIN_FRACTION_MAX:
        raise AssertionError(f"twin {label}: {name} {value} outside (0, {TWIN_FRACTION_MAX}]")


def _check_kernels_twin(lines):
    """The five lines of bench_kernels; returns the kernel line's launches."""
    recs = [json.loads(line) for line in lines]
    if len(recs) != len(BK.BENCHES) or [r["peak"] for r in recs] != ["fp32"] * 4 + ["int8"]:
        raise AssertionError(f"bench_kernels printed {[r.get('kernel') for r in recs]}")
    for r in recs:
        for key in ("compute_fraction", "hbm_fraction", "roofline_share"):
            _fraction("kernels", f"{r['kernel']}: {key}", r[key])
    top2 = recs[-1]
    if top2["function"] != "hamming_cuda.hamming_top2" or top2["launches"] < 1:
        raise AssertionError(f"the kernel line did not launch the kernel: {top2}")
    return top2["launches"]


def _check_lm_twin(lines):
    if lines[0] != "C=150 V=400 NB=4096 T=858" or any("FAILED" in line for line in lines):
        raise AssertionError(f"bench_lm_solvers: {lines}")
    solvers = [line.split(":")[0].strip() for line in lines[1:]]
    if solvers != ["cholesky", "cg"]:
        raise AssertionError(f"bench_lm_solvers ran {solvers}")


def _check_profile_twin(lines):
    if lines[-7] != "batch=2 1200x1600 on cuda":
        raise AssertionError(f"bench_extract_profile's table: {lines[-7:]}")
    for line in lines[-6:]:  # <stage> <ms> ms <images/s> img/s
        if not float(line.split()[-4]) > 0:
            raise AssertionError(f"bench_extract_profile: {line}")


def _check_fed_twin(lines):
    recs = [json.loads(line) for line in lines]
    if [r["diffusion"] for r in recs] != ["gaussian", "fed"]:
        raise AssertionError(f"bench_fed_ab printed {recs}")
    for r in recs:
        _fraction("fed_ab", f"{r['diffusion']}: repeatability_3px", r["repeatability_3px"])
        if not (0 < r["pairs_with_pose"] <= r["n_pairs"] == TWIN_FED_PAIRS and r["extract_s"] > 0
                and r["median_tilt_err_deg"] <= TWIN_TILT_DEG):
            raise AssertionError(f"bench_fed_ab: {r}")


def _check_overlap_twin(legs, directory):
    """Both legs end INITIAL_PROCESSING with the same nodes and edges; their
    poses are compared and the gap printed (bound PARITY_DEG and 1e-6 m)."""
    loaded = {}
    for leg, lines in legs.items():
        (rec,) = [json.loads(line) for line in lines]
        if not (rec["leg"] == leg and rec["overlap_io"] is (leg != "serial")
                and rec["final_state"] == PipelineState.MESH_REFINEMENT and rec["n_nodes"] == BENCH_IMAGES):
            raise AssertionError(f"bench_overlap_ab's {leg} leg: {rec}")
        p = Pipeline(batch_size=BENCH_CUT_BATCH, device="cuda")
        if not p.load_checkpoint(os.path.join(directory, f"overlap_{leg}")):
            raise AssertionError(f"the {leg} leg's checkpoint does not load")
        loaded[leg] = p
    a, b = (_by_path(loaded[leg]) for leg in ("serial", "overlap"))
    ea, eb = (set(_edge_paths(loaded[leg])) for leg in ("serial", "overlap"))
    if a.keys() != b.keys() or ea != eb:
        raise AssertionError(f"the overlap legs' graphs differ: {len(a)} / {len(b)} nodes, {len(ea)} / {len(eb)} "
                             f"edges, {len(ea ^ eb)} not in both")
    pos = max(float(np.max(np.abs(np.asarray(a[k].position) - np.asarray(b[k].position)))) for k in a)
    ang = float(np.max(_angles_deg(np.stack([a[k].orientation for k in a]), np.stack([b[k].orientation for k in a]))))
    same = all(np.array_equal(a[k].position, b[k].position) and np.array_equal(a[k].orientation, b[k].orientation)
               for k in a)
    print(f"[twins] overlap A/B at {BENCH_IMAGES} images: the same {len(a)} nodes and {len(ea)} edges; poses "
          f"{'bit for bit equal' if same else f'apart by up to {pos:.3e} m and {ang:.3e} deg'}")
    if pos > 1e-6 or ang > PARITY_DEG:
        raise AssertionError(f"the overlap legs' poses part by {pos} m, {ang} deg")


def phase_twins(runs, directory, smi):
    """Phase 16: wait for the twins' processes and check their lines.
    Returns the Hamming kernel's launches of the bench_kernels line."""
    lines = {label: _twin_lines(label, run, smi) for label, run in runs.items()}
    launches = _check_kernels_twin(lines["kernels"])
    _check_lm_twin(lines["lm_solvers"])
    _check_profile_twin(lines["extract_profile"])
    _check_fed_twin(lines["fed_ab"])
    _check_overlap_twin({leg: lines[f"overlap_{leg}"] for leg in ("serial", "overlap")}, directory)
    return launches


def main(argv=()):
    """With no arguments: every phase, then the ``kernels`` line and the
    ``ok`` line. ``--phases 1,2,9`` runs those phases alone (1 and 2 always
    run) and prints neither line; ``--keep-going`` lets phase 9's checks
    report and go on, and fails at the end."""
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
    laps = [t_start]

    def lap(label):  # the seconds of each phase, on the host clock
        laps.append(time.perf_counter())
        print(f"[time] {label}: {laps[-1] - laps[-2]:.1f} s ({laps[-1] - t_start:.1f} s in all)")

    name, count, smi = phase_device()
    phase_build()
    lap("phases 1-2")
    kernel = phase_kernel(smi) if want(3) else None
    lap("phase 3")
    if want(4):
        phase_cuda_vs_cpu()
    lap("phase 4")
    step_launches = phase_full_size() if want(5) else None
    lap("phase 5")
    if want(6):
        phase_pipeline_cuda_vs_cpu()
    lap("phase 6")
    ip_launches = mesh_launches = calib_launches = relief_entry = multi = multi_last = calib_entry = None
    multidev_launches = None
    if want(7):
        with tempfile.TemporaryDirectory() as d:
            multi, ip_launches, multi_last = phase_multi_group(d)
            images = np.stack([_read_pgm(os.path.join(d, f)) for f in sorted(os.listdir(d))
                               if f.endswith(".pgm")][:2]).astype(np.float32) * F.U8_SCALE
    lap("phase 7")
    if want(8) or want(10):  # phase 10 starts from a state of phase 8
        with tempfile.TemporaryDirectory() as d:
            mesh_launches, relief_entry = phase_mesh_refinement(d)
    lap("phase 8")
    if want(9):
        with tempfile.TemporaryDirectory() as d:
            calib_launches, calib_entry = phase_camera_relax(d)
    lap("phase 9")
    if want(10):
        phase_shared_solver(relief_entry)
    lap("phase 10")
    if want(11):
        phase_ortho_cuda_vs_cpu()
    lap("phase 11")
    runner_launches = phase_runner() if want(12) else None
    lap("phase 12")
    if want(13):
        if multi is None:  # run alone: phase 6's survey and two views of phase 7's scene
            images = np.stack([v.cpu().numpy() for v in _scene(dict(MULTI, rows=1, cols=2), "cuda")[0]])
            with tempfile.TemporaryDirectory() as d:
                paths, _, _ = S.write_survey(d, SMALL["rows"], SMALL["cols"], device="cuda")
                multi = Pipeline(batch_size=3, device="cuda")
                _initial_processing(multi, paths)
        phase_entry_points(images, multi)
    lap("phase 13")
    if want(14):
        multidev_launches = phase_multi_device(multi_last, calib_entry)
    lap("phase 14")
    bench_launches = resume_launches = twin_launches = None
    with tempfile.TemporaryDirectory() as twin_dir:
        bench = start_bench() if want(15) else None
        if want(15):
            resume_launches = phase_bench()
        # phase 16's processes run beside 15 (a)'s, which outlives (c)
        twins = start_twins(twin_dir) if want(16) else None
        if bench is not None:
            bench_launches = _bench_line(bench)
        lap("phase 15")
        if twins is not None:
            twin_launches = phase_twins(twins, twin_dir, smi)
    lap("phase 16")
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
        paths={"pipeline from 24 JPEG images over relief, every state (dense mesh on) to COMPLETE": calib_launches,
               "pipeline_runner CLI from JPEG, 6 images at 320x240, flat, --dense-mesh 1, to COMPLETE":
                   runner_launches,
               "pipeline INITIAL_PROCESSING..MESH_REFINEMENT, 9 images at 320x240, relief": mesh_launches,
               "pipeline INITIAL_PROCESSING..FINAL_GLOBAL_RELAX, 56 images, flat, two pose groups": ip_launches,
               "calibration_step": step_launches,
               "multi-device paths: sharded BA, dry run, lanes and joint solve over shards (no link)":
                   multidev_launches,
               "bench twin (python -m opencalibration_tpu_torch.bench.bench, its own process): 16 calibration steps "
               "and two 24-image runs with the orthomosaic": bench_launches,
               f"bench_e2e.run_config({BENCH_IMAGES}) resumed from a mid-INITIAL_PROCESSING checkpoint to COMPLETE":
                   resume_launches,
               f"bench_kernels twin, hamming top-2 at [1, {BK.HAMMING_N}, {BK.HAMMING_N}] (its own process)":
                   twin_launches},
        **kernel,
    )]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


def _stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    finally:
        _stop_children()
