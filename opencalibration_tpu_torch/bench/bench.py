"""The port's benchmark on the card, one JSON line (twin of the repository's
bench.py)::

    python -m opencalibration_tpu_torch.bench.bench

Metric (``value``): images a second end to end through the port's real
pipeline on the 24-image survey, orthomosaic, DSM and camera-id GeoTIFFs
included, warm: the second of two runs in one process (``e2e.cold`` is the
first). ``e2e.cpu_node_1core`` (bench.py's key) is the same run on this
host's CPU in a subprocess, every core it has; ``BENCH_SKIP_CPU_E2E=1``
skips it, and ``vs_baseline`` is the warm run's rate over it.
``compute_kernel`` is the calibration step (extract, link, relax) on the
24-image workload: images a second on the card (``device_ips``, bench.py's
``tpu_ips``; median of 5 rounds of 3 steps) and over one step on the CPU
(``vs_cpu``). ``device`` names the card and its power limit, ``step_s`` is
the step's median seconds and ``hamming_launches`` counts the Hamming top-2
kernel's launches of each part.

Without a card it raises and exits non-zero: there is no CPU fallback, and a
leg that fails raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from opencalibration_tpu_torch.bench import bench_e2e
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.pipeline import calibration as C
from opencalibration_tpu_torch.testing import survey as S

N_IMAGES = 24
ROWS = 4
NEIGHBOURS = 3
SPACING = 12.0
MAX_FEATURES = 1024
# bench.py's keys of an end-to-end leg, then the port's additions
_E2E_KEYS = (
    "n_images", "wall_s", "images_per_sec_e2e", "lm_iterations",
    "median_pose_err_m", "final_state", "focal_err_px",
    "ortho_artifacts", "state_s", "peak_memory_gib", "hamming_launches",
)


def build_workload(*, device="cuda"):
    """bench.py's workload: 24 images at 320 x 240 on a 4 x 6 grid 12 m
    apart, each linked to its 3 nearest neighbours (42 pairs). Rendered on
    ``device``; returns numpy (images [24, H, W] float32, positions [24, 3],
    pa, pb)."""
    positions, quats = S.camera_grid(ROWS, N_IMAGES // ROWS, spacing=SPACING)
    views = S.render_views(S.make_texture(0), positions, quats, device=device)
    pa, pb = S.knn_pairs(positions, NEIGHBOURS)
    return views.cpu().numpy(), positions, pa, pb


def calibration_step(images, positions, pa, pb):
    """One step of the workload: extract, link, relax (rotations [C, 4])."""
    return C.calibration_step(images, positions, pa, pb, focal=S.FOCAL, max_features=MAX_FEATURES)


def time_platform(images, positions, pa, pb, *, device, repeats=3, rounds=1):
    """Seconds a step on ``device``: the inputs moved there once, one
    warm-up step, then ``rounds`` rounds of ``repeats`` steps, each round
    ended by a synchronise; the median round's mean."""
    dev = torch.device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    positions = torch.as_tensor(positions, dtype=torch.float32, device=dev)
    pa, pb = torch.as_tensor(pa, device=dev), torch.as_tensor(pb, device=dev)
    calibration_step(images, positions, pa, pb)
    bench_e2e._sync(dev)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(repeats):
            calibration_step(images, positions, pa, pb)
        bench_e2e._sync(dev)
        times.append((time.perf_counter() - t0) / repeats)
    return sorted(times)[len(times) // 2]


def _e2e_leg(device="cuda"):
    """The 24-image survey through the real pipeline to COMPLETE, with the
    orthomosaic, DSM and camera-id GeoTIFFs written to a temporary
    directory."""
    with tempfile.TemporaryDirectory() as td:
        os.environ["BENCH_E2E_ORTHO"] = td
        try:
            e2e = bench_e2e.run_config(N_IMAGES, batch_size=N_IMAGES, device=device)
        finally:
            os.environ.pop("BENCH_E2E_ORTHO", None)
    return {k: e2e[k] for k in _E2E_KEYS if k in e2e}


def _cpu_node_e2e(timeout_s: float = 1500.0):
    """The same leg on this host's CPU, in a subprocess that names the
    device explicitly."""
    code = ("import json; from opencalibration_tpu_torch.bench.bench_e2e import run_config; "
            f"e2e = run_config({N_IMAGES}, batch_size={N_IMAGES}, device='cpu'); print('CPUE2E ' + json.dumps(e2e))")
    with tempfile.TemporaryDirectory() as td:
        r = subprocess.run([sys.executable, "-c", code], timeout=timeout_s, capture_output=True, text=True,
                           env=dict(os.environ, BENCH_E2E_ORTHO=td), cwd=bench_e2e.ROOT)
    for line in r.stdout.splitlines():
        if line.startswith("CPUE2E "):
            e2e = json.loads(line[len("CPUE2E "):])
            return {k: e2e[k] for k in _E2E_KEYS if k in e2e}
    raise RuntimeError(f"the CPU leg failed (exit {r.returncode}): {r.stderr[-3000:]}")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("the benchmark runs on a CUDA device, and torch.cuda.is_available() is False")
    images, positions, pa, pb = build_workload(device="cuda")

    launches0 = hamming_cuda.hamming_top2.launches
    step_s = time_platform(images, positions, pa, pb, device="cuda", rounds=5)
    step_launches = hamming_cuda.hamming_top2.launches - launches0
    device_ips = N_IMAGES / step_s
    cpu_ips = N_IMAGES / time_platform(images, positions, pa, pb, device="cpu", repeats=1)

    e2e_cold = _e2e_leg()
    e2e_warm = _e2e_leg()
    cpu_e2e = None if os.environ.get("BENCH_SKIP_CPU_E2E", "") == "1" else _cpu_node_e2e()

    warm_ips = e2e_warm["images_per_sec_e2e"]
    result = {
        "metric": "images/sec end-to-end (24-image survey incl. orthomosaic, warm)",
        "value": warm_ips,
        "unit": "images/sec",
        "vs_baseline": round(warm_ips / cpu_e2e["images_per_sec_e2e"], 2) if cpu_e2e else None,
        "e2e": {"cold": e2e_cold, "warm": e2e_warm, "cpu_node_1core": cpu_e2e},
        "compute_kernel": {
            "metric": "images/sec calibration compute (extract + match + ransac + relax)",
            "device_ips": round(device_ips, 3),
            "vs_cpu": round(device_ips / cpu_ips, 2),
        },
        "device": bench_e2e.device_line("cuda"),
        "step_s": step_s,
        "hamming_launches": {"calibration_step": step_launches, "e2e_cold": e2e_cold["hamming_launches"],
                             "e2e_warm": e2e_warm["hamming_launches"]},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
