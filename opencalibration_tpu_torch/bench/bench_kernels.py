"""The port's hot functions timed beside the H100's rooflines (twin of the
repository's bench_kernels.py)::

    python -m opencalibration_tpu_torch.bench.bench_kernels [--device cuda|cpu]

The first line is the device: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them. Then one JSON line
per function, at the original's sizes, seeds and repeats: feature extraction
(8 x 1200 x 1600, 2048 keypoints), ``hamming_matrix`` at 4096 x 4096, RANSAC
homography with poses (4096 hypotheses x 1024 matches), 30 LM iterations of
a 50-camera plane-ray problem, and the port's hand-written kernel,
``hamming_top2``, on the Hamming line's descriptors as [1, 4096, 4096] with
every column valid (on the CPU its plain version, ``hamming_top2_reference``).
Each time is the mean of the repeats after one warm-up call, on the host clock
with the device synchronised before every reading.

The keys are the original's (``kernel``, ``time_ms``, ``gflops``,
``achieved_tflops``, ``achieved_gbps``, ``hbm_fraction``), with
``compute_fraction`` in place of ``mxu_fraction``, and ``peak`` (the peak
the operations are held to), ``roofline_share`` (the least time the card
could take, the larger of operations / peak and bytes / bandwidth, over the
time) and ``bound_by``. Peaks are NVIDIA's published H100 SXM figures (dense,
at 700 W): every line but the kernel's runs float32 with TF32 off
(``utils/device.py::full_fp32``) and is held to 67 TFLOP/s outside the tensor
cores; the kernel runs on the int8 tensor cores, 1,979 TOP/s; memory 3.35
TB/s.

The counts are of the work the inputs need, not of what an implementation
does: each input byte read once, each output byte written once, in the
port's dtypes. The Hamming, RANSAC and LM operation counts are the
original's formulas, since that work is the same in both packages; their
byte counts are not (the original counted the expanded +-1 operands, the
[K, N] scoring matrix and per-iteration Jacobians and normal matrices, which
are intermediates). A Hamming distance is a 486-deep multiply-add, the
descriptor's bits: the original's 512 counted the padding to whole words.
Extraction is counted as the separable Gaussian taps of ``ops/features.py``'s
own sigmas (radius ceil(3 sigma)), the derivatives the function uses (Lx, Ly,
Lxx, Lxy, Lyy for the Hessian; Lx, Ly for the descriptor), each a Sobel
filter in separable form (a 3-tap smoothing and a 2-tap difference), and the
bilinear samples of ``describe``, a multiply-add two operations; the
original's count (2 H W^2 + 2 H^2 W a level) is its banded Toeplitz
products, about a hundred times this. Comparisons (NMS, top-k, the descriptor
bits) are not counted, so the extraction bound is a lower one.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from opencalibration_tpu_torch.bench import bench_e2e
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as Hm
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.ops import ransac as R
from opencalibration_tpu_torch.relax import blocks as B_
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import resolve_device

# NVIDIA's published H100 SXM peaks (dense, at 700 W)
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_INT8_OPS = 1979e12  # int8 tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3
PEAKS = {"fp32": H100_FP32_FLOPS, "int8": H100_INT8_OPS}

# the original's workloads
EXTRACT_SHAPE, EXTRACT_FEATURES = (8, 1200, 1600), 2048
HAMMING_N = 4096
RANSAC_MATCHES, RANSAC_HYPOTHESES = 1024, 4096
LM_C, LM_V, LM_M, LM_NB, LM_ITERATIONS = 50, 512, 1, 2048, 30
LM_L, LM_R = 24, 15  # a plane-ray block's local tangent and residuals

# bytes of one keypoint of ``extract_features``: xy, strength, sigma (float32),
# level (int64), valid (bool), angle (float32), descriptors (16 int32 words)
KEYPOINT_BYTES = 2 * 4 + 4 + 4 + 8 + 1 + 4 + Hm.DESCRIPTOR_WORDS * 4


def timeit(fn, *args, repeats=10, device):
    """Seconds a call: one warm-up call, then ``repeats`` calls, the device
    synchronised before each clock reading."""
    fn(*args)
    bench_e2e._sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    bench_e2e._sync(device)
    return (time.perf_counter() - t0) / repeats


def roofline(seconds, ops, bytes_moved, peak="fp32"):
    """The line's rates and shares against the H100's ``peak`` and memory
    rate: (fields, bound_ms)."""
    t_ops, t_bytes = ops / PEAKS[peak], bytes_moved / H100_BYTES_PER_S
    bound_s = max(t_ops, t_bytes)
    return dict(
        achieved_tflops=ops / seconds / 1e12,
        compute_fraction=t_ops / seconds,
        achieved_gbps=bytes_moved / seconds / 1e9,
        hbm_fraction=t_bytes / seconds,
        peak=peak,
        roofline_share=bound_s / seconds,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    ), 1e3 * bound_s


def report(name, seconds, flops, bytes_moved, extra=None, peak="fp32"):
    fields, bound_ms = roofline(seconds, flops, bytes_moved, peak)
    rec = dict(kernel=name, time_ms=seconds * 1e3, gflops=flops / 1e9, bytes=bytes_moved, bound_ms=bound_ms,
               **fields)
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def _nbytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (tensors, dataclasses of tensors,
    dicts, tuples and lists of them)."""
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            total += _nbytes(*obj.values())
        elif isinstance(obj, (tuple, list)):
            total += _nbytes(*obj)
        elif hasattr(obj, "__dataclass_fields__"):
            total += _nbytes(*(getattr(obj, f) for f in obj.__dataclass_fields__))
    return total


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------


def _blur_ops(pixels: int, sigma: float) -> int:
    """Two passes of 2 r + 1 multiply-adds a pixel."""
    return 2 * 2 * len(F._gaussian_taps(float(sigma))) * pixels


# a Sobel derivative in separable form: 3 smoothing taps and 2 difference
# taps (the centre is zero), a multiply-add each
_DERIVATIVE_OPS = 2 * (3 + 2)


def extract_ops(B: int, H: int, W: int, K: int) -> int:
    """Operations of ``extract_features`` (gaussian) on [B, H, W] with K
    keypoints, as ``detect`` and ``describe`` need them: the base blur; per
    octave the three sublevel blurs (the first sublevel is the base), the
    Hessian of four levels (the five derivatives Lx, Ly, Lxx, Lxy, Lyy, the
    determinant and its scale: 54 a pixel) and, below the last octave, the
    blur to the next base; in ``describe`` the blur by 1, the two gradients
    and per keypoint 9 orientation and 29 cell samples of three channels, 4
    multiply-adds each."""
    rels = [F.BASE_SIGMA * 2.0 ** (s / F.SUBLEVELS) for s in range(F.SUBLEVELS)]
    ops = _blur_ops(B * H * W, F.BASE_SIGMA)
    h, w = H, W
    octaves = [o for o in range(F.NUM_OCTAVES) if min(-(-H // 2**o), -(-W // 2**o)) >= 8]
    for o in octaves:
        px = B * h * w
        ops += sum(_blur_ops(px, math.sqrt(r * r - F.BASE_SIGMA**2)) for r in rels[1:])
        ops += F.SUBLEVELS * px * (5 * _DERIVATIVE_OPS + 4)
        if o != octaves[-1]:
            ops += _blur_ops(px, math.sqrt((2 * F.BASE_SIGMA) ** 2 - rels[-1] ** 2))
        h, w = -(-h // 2), -(-w // 2)
    ops += _blur_ops(B * H * W, 1.0) + 2 * _DERIVATIVE_OPS * B * H * W
    ops += B * K * (len(F._ORI_OFFSETS) + len(F._CELL_CENTERS)) * 3 * 4 * 2
    return ops


def hamming_ops(pairs: int, n1: int, n2: int) -> int:
    """A multiply-add per descriptor bit and distance: 2 P N1 N2 486."""
    return 2 * pairs * n1 * n2 * Hm.DESCRIPTOR_BITS


def hamming_top2_bytes(pairs: int, n1: int, n2: int) -> int:
    """The kernel's inputs (packed words of both sets, valid2) and its three
    int32 results."""
    return pairs * ((n1 + n2) * 4 * Hm.DESCRIPTOR_WORDS + n2 + 3 * 4 * n1)


def hamming_top2_bound(pairs: int, n1: int, n2: int):
    """The least time the card could take for one launch of the kernel at
    [pairs, n1, n2] on the int8 tensor cores: (ms, bound_by)."""
    t_ops = hamming_ops(pairs, n1, n2) / H100_INT8_OPS
    t_bytes = hamming_top2_bytes(pairs, n1, n2) / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ransac_ops(hypotheses: int, matches: int) -> int:
    """Per hypothesis a closed-form 4-point fit (~2k) and an error on every
    match (~60)."""
    return hypotheses * (2000 + matches * 60)


def ransac_output_bytes(matches: int) -> int:
    """The model [3, 3], inliers [N] (bool), score, four poses' quaternions
    [4, 4], translations [4, 3] and scores [4], float32."""
    return 9 * 4 + matches + 4 + 16 * 4 + 12 * 4 + 4 * 4


def lm_ops(blocks: int, T: int, iterations: int) -> float:
    """Per iteration the residuals and their forward Jacobian (NB L R 40),
    J^T J (NB 2 R L^2) and a dense solve (2/3 T^3)."""
    return iterations * (blocks * LM_L * LM_R * 40 + blocks * 2 * LM_R * LM_L * LM_L + (2 / 3) * T**3)


# ---------------------------------------------------------------------------
# The lines
# ---------------------------------------------------------------------------


def extract_inputs(B, H, W, *, device):
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.random((B, H, W), np.float32), device=device)


def bench_extract(*, device, shape=EXTRACT_SHAPE, max_features=EXTRACT_FEATURES):
    B, H, W = shape
    imgs = extract_inputs(B, H, W, device=device)
    t = timeit(lambda x: F.extract_features(x, max_features=max_features), imgs, repeats=5, device=device)
    flops = extract_ops(B, H, W, max_features)
    bytes_moved = _nbytes(imgs) + B * max_features * KEYPOINT_BYTES
    return report(f"feature extraction ({B}x{H}x{W}, {max_features} kp)", t, flops, bytes_moved,
                  dict(images_per_sec=B / t))


def hamming_inputs(N, *, device):
    """Two sets of N random 512-bit descriptors (the original's uint32 words,
    held as int32 bit patterns)."""
    rng = np.random.default_rng(1)
    d1 = rng.integers(0, 2**32, (N, 16), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (N, 16), dtype=np.uint32)
    return tuple(torch.as_tensor(d.view(np.int32), device=device) for d in (d1, d2))


def bench_hamming(*, device, N=HAMMING_N):
    d1, d2 = hamming_inputs(N, device=device)
    t = timeit(Hm.hamming_matrix, d1, d2, device=device)
    flops = hamming_ops(1, N, N)
    bytes_moved = _nbytes(d1, d2) + N * N * 4
    return report(f"hamming matrix {N}x{N} (486-bit)", t, flops, bytes_moved, dict(pairs_per_sec=N * N / t / 1e6))


def bench_hamming_top2(*, device, N=HAMMING_N):
    """The kernel on the Hamming line's descriptors, one pair of N x N with
    every column valid; on the CPU its plain version."""
    d1, d2 = hamming_inputs(N, device=device)
    p1, p2 = d1[None], d2[None]
    valid2 = torch.ones((1, N), dtype=torch.bool, device=device)
    on_card = torch.device(device).type == "cuda"
    fn = hamming_cuda.hamming_top2 if on_card else Hm.hamming_top2_reference
    launches0 = hamming_cuda.hamming_top2.launches
    t = timeit(fn, p1, p2, valid2, device=device)
    launches = hamming_cuda.hamming_top2.launches - launches0
    return report(f"hamming top-2 [1, {N}, {N}] (486-bit)", t, hamming_ops(1, N, N), hamming_top2_bytes(1, N, N),
                  dict(pairs_per_sec=N * N / t / 1e6, launches=launches,
                       function="hamming_cuda.hamming_top2" if on_card else "hamming.hamming_top2_reference"),
                  peak="int8")


def ransac_inputs(N, *, device):
    rng = np.random.default_rng(2)
    r1 = rng.normal(size=(N, 3)).astype(np.float32)
    r2 = rng.normal(size=(N, 3)).astype(np.float32)
    dist = rng.random(N).astype(np.float32)
    return (torch.as_tensor(r1, device=device), torch.as_tensor(r2, device=device),
            torch.as_tensor(dist, device=device), torch.ones(N, dtype=torch.bool, device=device))


def bench_ransac(*, device, N=RANSAC_MATCHES, Hyp=RANSAC_HYPOTHESES):
    args = ransac_inputs(N, device=device)
    t = timeit(lambda a, b, d, v: R.ransac_homography_with_poses(a, b, d, v, num_hypotheses=Hyp), *args,
               device=device)
    bytes_moved = _nbytes(args) + ransac_output_bytes(N)
    return report(f"RANSAC homography ({Hyp} hyp x {N} matches)", t, ransac_ops(Hyp, N), bytes_moved)


def lm_problem(C=LM_C, V=LM_V, NB=LM_NB, *, device):
    """The original's problem: C nadir cameras, V mesh heights, NB plane-ray
    blocks of fixed camera-frame rays and the downwards prior; float32.
    Returns (params, (plane-ray block, prior), layout, free mask)."""
    M = LM_M
    dev = torch.device(device)
    f32 = torch.float32
    rng = np.random.default_rng(3)
    DOWN = np.array([0.0, 1, 0, 0], np.float32)
    params = RelaxParams.create(
        torch.as_tensor(np.tile(DOWN, (C, 1)), dtype=f32, device=dev),
        torch.as_tensor(rng.uniform(0, 100, (C, 3)), dtype=f32, device=dev),
        mesh_z=torch.zeros(V, dtype=f32, device=dev),
        focal=torch.tensor([400.0], dtype=f32, device=dev),
        principal=torch.tensor([[800.0, 600.0]], dtype=f32, device=dev),
        dtype=f32,
    )
    layout = TangentLayout(C, V, 0, M)
    blk = B_.plane_ray_block(
        layout,
        torch.as_tensor(rng.integers(0, V, (NB, 3)), dtype=torch.int64, device=dev),
        torch.as_tensor(rng.uniform(0, 100, (NB, 3, 2)), dtype=f32, device=dev),
        torch.as_tensor(rng.integers(0, C, (NB, 5)), dtype=torch.int64, device=dev),
        torch.as_tensor(rng.random((NB, 5)) < 0.6, device=dev),
        torch.ones(NB, dtype=f32, device=dev),
        fixed_dir=torch.as_tensor(rng.normal(size=(NB, 5, 3)).astype(np.float32), device=dev),
    )
    down = B_.downwards_prior_block(layout, torch.arange(C, device=dev), torch.ones(C, dtype=f32, device=dev))
    return params, (blk, down), layout, layout.build_free_mask(device=dev)


def bench_lm(*, device, C=LM_C, V=LM_V, NB=LM_NB, n_iter=LM_ITERATIONS):
    params, blocks, layout, free = lm_problem(C, V, NB, device=device)

    def run(p):
        solved, info = lm.solve(
            p, blocks, layout, free, max_iterations=n_iter,
            function_tolerance=0.0, parameter_tolerance=0.0,
        )
        return solved.quats, info.iterations

    t = timeit(run, params, repeats=3, device=device)
    T = layout.dim
    flops = lm_ops(NB, T, n_iter)
    # in: the parameters, both blocks and the free mask; out: quaternions and the count
    bytes_moved = _nbytes(params, blocks, free) + _nbytes(params.quats) + 8
    return report(
        f"LM bundle adjust (C={C} V={V} blocks={NB}, {n_iter} iters)", t, flops, bytes_moved,
        dict(lm_iters_per_sec=n_iter / t, ms_per_iteration=1e3 * t / n_iter, T=T, route=lm.route(T)),
    )


BENCHES = (bench_extract, bench_hamming, bench_ransac, bench_lm, bench_hamming_top2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    print(bench_e2e.device_line(dev), flush=True)
    for b in BENCHES:
        b(device=dev)


if __name__ == "__main__":
    main()
