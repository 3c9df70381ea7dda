"""Device selection and float32 numerics for the port."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """The device the caller names, as a ``torch.device``.

    Never chooses one itself: ``None`` is an error, and a CUDA device without
    a usable card raises instead of quietly running on the CPU."""
    if device is None:
        raise ValueError("name a device, e.g. 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and cuDNN convolutions in full float32.

    cuDNN convolutions default to TF32 on the card (about three decimal
    digits), which the sigma^4-normalised detector response amplifies past
    its threshold, and the LM normal equations mix rotation and focal units
    that TF32 products would wreck. The JAX reference asks for the same with
    ``Precision.HIGHEST`` and ``default_matmul_precision("float32")``.
    Restores the previous flags on exit."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved


@contextlib.contextmanager
def lane_invariant_linalg():
    """Factor every matrix of a lane-batched solve on the card with cuSOLVER.

    PyTorch's default picks the factorisation by the batch size (a batched
    cuBLAS or MAGMA kernel for several small matrices, cuSOLVER for one), so
    a lane's last bits would depend on how many lanes share its call, and
    the same group would solve differently on one device and on a shard.
    Pinned, a lane's factorisation is the same in any batch
    (``tools/torch_shard_bits.py``). Restores the previous choice on exit;
    nothing changes where there is no card."""
    if not torch.cuda.is_available():
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)
