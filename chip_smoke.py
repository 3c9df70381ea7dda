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
   scene's ground truth.

Run from the repository root with ``python3 chip_smoke.py``. Any failed
check raises, so the exit code is non-zero; without a CUDA device it exits
with 1 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
from opencalibration_tpu_torch.pipeline import calibration as C
from opencalibration_tpu_torch.testing import survey as S

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


def _main_path_case(rng, pairs=42, n=2048):
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


def phase_kernel():
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    main = ("main path [42, 2048, 2048]",) + _main_path_case(rng)
    max_err = 0.0
    for name, p1, p2, v1, v2 in _kernel_cases(rng) + [main]:
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

    _, p1, p2, v1, v2 = main
    p1, p2, v1, v2 = (t.to(dev).contiguous() for t in (p1, p2, v1, v2))
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = H.match_descriptors if which == "kernel" else H.match_descriptors_reference
        runs[which].append(_cuda_ms(lambda: fn(p1, p2, v1, v2), 20))
    ms, plain_ms = statistics.mean(runs["kernel"]), statistics.mean(runs["plain"])
    print(f"[kernel] match_descriptors at [42, 2048, 2048]: kernel {runs['kernel']} ms, "
          f"plain {runs['plain']} ms (CUDA events, 20 launches each, plain/kernel/kernel/plain)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    name, count, _ = phase_device()
    phase_build()
    kernel = phase_kernel()
    phase_cuda_vs_cpu()
    launches = phase_full_size()
    print(json.dumps({"kernels": [dict(
        name="hamming_top2", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL_REPLACES,
        launches=launches, **kernel,
    )]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
