"""bench_fed_ab's twin on the CPU: ``run_mode`` of both packages, both
modes, on a 2 x 3 block of the bench workload (images 0, 1, 2, 6, 7, 8 of
bench.py's 4 x 6 grid and the 8 of its 42 pairs between them). About 55 s
alone on this suite's one torch thread, most of it the two packages' ``fed``
extractions.

The JAX side runs in its float32 blur mode (its default bfloat16 blur is
another chain, ROADMAP 3b), restored after the module. The same keys and
``n_pairs``; the rest within what was measured here: the repeatability
equal to the original's four decimals (it rounds); the mean best pose score
within 1 % and the pairs with a pose within 1 (measured equal); the median
tilt within 0.05 degrees (measured 0.024 for ``gaussian``, 0.005 for
``fed``: the two packages draw RANSAC samples from other generators, and
their keypoints differ by about 1e-4 px, ROADMAP 3b).
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_fed_ab as JFA  # noqa: E402
from opencalibration_tpu.ops import features as JF  # noqa: E402
from opencalibration_tpu_torch.bench import bench as TBENCH  # noqa: E402
from opencalibration_tpu_torch.bench import bench_fed_ab as TFA  # noqa: E402
from opencalibration_tpu_torch.testing import survey as TS  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

SUBSET = [0, 1, 2, 6, 7, 8]  # a 2 x 3 block of bench.py's 4 x 6 grid
REPEATABILITY_ABS = 5e-5  # the original rounds to 4 decimals
SCORE_REL = 0.01
PAIRS_WITH_POSE = 1
TILT_DEG = 0.05


@pytest.fixture(scope="module")
def f32_blur():
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    yield
    JF.set_blur_precision(prior)


@pytest.fixture(scope="module")
def subset():
    images, positions, pa, pb = TBENCH.build_workload(device="cpu")
    _, quats = TS.camera_grid(TBENCH.ROWS, TBENCH.N_IMAGES // TBENCH.ROWS, spacing=TBENCH.SPACING)
    index = {g: i for i, g in enumerate(SUBSET)}
    keep = [k for k in range(len(pa)) if pa[k] in index and pb[k] in index]
    spa = np.asarray([index[pa[k]] for k in keep], np.int32)
    spb = np.asarray([index[pb[k]] for k in keep], np.int32)
    return images[SUBSET], positions[SUBSET], quats[SUBSET], spa, spb


@pytest.mark.parametrize("mode", ["gaussian", "fed"])
def test_run_mode_matches_the_original(subset, f32_blur, mode):
    got = TFA.run_mode(mode, *subset, device="cpu")
    want = JFA.run_mode(mode, *subset)
    assert got.keys() == want.keys()
    assert got["diffusion"] == mode and got["n_pairs"] == want["n_pairs"] == 8
    assert got["extract_s"] > 0 and got["images_per_sec_extract"] > 0
    assert abs(got["repeatability_3px"] - want["repeatability_3px"]) <= REPEATABILITY_ABS
    assert abs(got["mean_best_pose_score"] - want["mean_best_pose_score"]) <= SCORE_REL * want["mean_best_pose_score"]
    assert abs(got["pairs_with_pose"] - want["pairs_with_pose"]) <= PAIRS_WITH_POSE
    assert abs(got["median_tilt_err_deg"] - want["median_tilt_err_deg"]) <= TILT_DEG

