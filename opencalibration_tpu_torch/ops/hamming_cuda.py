"""Hand-written CUDA Hamming top-2 kernel (twin of
opencalibration_tpu/ops/hamming_pallas.py).

``csrc/hamming_top2.cu`` (int8 ``wgmma`` on the tensor cores) is compiled by
``nvcc`` for ``sm_90a`` at first use into a shared library with a plain C
interface, loaded with ``ctypes``. The library goes to ``build/kernels/``
beside the package, named by a hash of the source, so an edited kernel is
rebuilt and an unchanged one is reused.

``hamming_top2`` takes CUDA tensors only and raises on anything else: the
plain version (``hamming.hamming_top2_reference``) is chosen by
``hamming.match_descriptors`` for CPU tensors, never here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from opencalibration_tpu_torch.ops.hamming import DESCRIPTOR_WORDS

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "hamming_top2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    library: Path
    seconds: float  # compile time; 0.0 when an earlier build was reused
    ptxas: str  # the -Xptxas -v report (registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def build() -> BuildInfo:
    """Compile the kernel library unless a build of this exact source exists."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libhamming_top2_{digest}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().library))
    fn = lib.hamming_top2_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hamming_top2(packed1, packed2, valid2):
    """Best distance, second distance and best index per set-1 row.

    packed1 [P, N1, 16] / [N1, 16] and packed2 [P, N2, 16] / [N2, 16] int32
    (the uint32 words' bit patterns), valid2 [P, N2] / [N2] bool, all
    contiguous on one CUDA device. Returns (best, second, idx) int32 [P, N1]
    (or [N1]), bit-exact with ``hamming.hamming_top2_reference``. One launch
    (of one thread-block cluster per set-1 tile where set 2 is split) covers
    every pair; it runs on the current stream and is not awaited."""
    squeeze = packed1.dim() == 2
    if squeeze:
        packed1, packed2, valid2 = packed1[None], packed2[None], valid2[None]
    if packed1.dim() != 3:
        raise ValueError(f"packed1 must be [P, N1, 16] or [N1, 16], got {tuple(packed1.shape)}")
    P, n1 = packed1.shape[:2]
    n2 = packed2.shape[1]
    _check("packed1", packed1, torch.int32, (P, n1, DESCRIPTOR_WORDS))
    _check("packed2", packed2, torch.int32, (P, n2, DESCRIPTOR_WORDS))
    _check("valid2", valid2, torch.bool, (P, n2))
    if packed2.device != packed1.device or valid2.device != packed1.device:
        raise ValueError("all inputs must be on one device")
    if packed1.data_ptr() % 16 or packed2.data_ptr() % 16:
        raise ValueError("packed descriptors must be 16-byte aligned")
    if P > 65535:
        raise ValueError(f"at most 65535 pairs per launch, got {P}")

    lib = _library()
    with torch.cuda.device(packed1.device):
        best = torch.empty((P, n1), dtype=torch.int32, device=packed1.device)
        second = torch.empty_like(best)
        idx = torch.empty_like(best)
        err = lib.hamming_top2_launch(
            packed1.data_ptr(), packed2.data_ptr(), valid2.data_ptr(), P, n1, n2,
            best.data_ptr(), second.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hamming_top2 launch failed: cudaError {err}")
    hamming_top2.launches += 1
    if squeeze:
        return best[0], second[0], idx[0]
    return best, second, idx


hamming_top2.launches = 0
