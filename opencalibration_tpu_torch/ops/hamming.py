"""Binary-descriptor Hamming matching (twin of opencalibration_tpu/ops/hamming.py).

Descriptors are 486-bit MLDB bitstrings packed into 16 words of 32 bits
(padded to 512 bits). Torch has no right shift for ``uint32`` on the CPU, so
packed words are ``int32`` tensors holding the uint32 bit patterns; every
shift is followed by a mask, which makes the arithmetic shift of a negative
word harmless.

``match_descriptors`` is the entry point. It follows the tensor's device:
a CUDA tensor goes to the hand-written top-2 kernel
(``ops.hamming_cuda``), a CPU tensor to ``match_descriptors_reference``, the
plain twin of the reference's ``_match_descriptors_xla``. Both give the same
bits.
"""

from __future__ import annotations

import torch

from opencalibration_tpu_torch.utils.device import full_fp32

DESCRIPTOR_BITS = 486
WORD_BITS = 32
DESCRIPTOR_WORDS = (DESCRIPTOR_BITS + WORD_BITS - 1) // WORD_BITS  # 16
PADDED_BITS = DESCRIPTOR_WORDS * WORD_BITS  # 512
LOWE_RATIO = 0.8
# distance of an invalid set-2 column; above any real distance (<= 486)
SENTINEL = 2 * PADDED_BITS


def _shifts(device):
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_bits(bits) -> torch.Tensor:
    """Boolean [..., n_bits] (bit k -> word k // 32, bit k % 32) -> int32
    words [..., ceil(n_bits / 32)] holding the uint32 bit patterns."""
    bits = torch.as_tensor(bits).to(torch.int64)
    n_bits = bits.shape[-1]
    n_words = (n_bits + WORD_BITS - 1) // WORD_BITS
    pad = n_words * WORD_BITS - n_bits
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (n_words, WORD_BITS))
    words = torch.sum(bits << _shifts(bits.device).to(torch.int64), dim=-1)
    # [0, 2^32) -> the same 32 bits as a signed int32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed, n_bits: int = DESCRIPTOR_BITS) -> torch.Tensor:
    """int32 words [..., W] -> boolean [..., n_bits]."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * WORD_BITS,))
    return flat[..., :n_bits].to(torch.bool)


def _unpack_pm1(packed, n_bits: int, dtype=torch.int8) -> torch.Tensor:
    """int32 words -> {-1, +1} for real bits, 0 for padding bits."""
    bits = ((packed[..., None] >> _shifts(packed.device)) & 1).to(dtype)
    flat = (bits * 2 - 1).reshape(packed.shape[:-1] + (packed.shape[-1] * WORD_BITS,))
    total = flat.shape[-1]
    if n_bits < total:
        flat = flat * (torch.arange(total, device=packed.device) < n_bits).to(dtype)
    return flat


def hamming_matrix(packed1, packed2, n_bits: int = DESCRIPTOR_BITS) -> torch.Tensor:
    """Hamming distances [..., N1, N2] (int32) from a +-1 similarity product.

    The product runs in float32, which is exact here (|sim| <= 486, far below
    2^24) once TF32 is off; integer matmuls are not used because CPU
    ``int8 @ int8`` stays int8 and overflows, and the card has no general
    int32 GEMM."""
    a = _unpack_pm1(packed1, n_bits, torch.float32)
    b = _unpack_pm1(packed2, n_bits, torch.float32)
    with full_fp32():
        sim = torch.matmul(a, b.transpose(-1, -2))
    return (n_bits - sim.to(torch.int32)) >> 1


def hamming_matrix_popcount(packed1, packed2) -> torch.Tensor:
    """XOR + popcount over all padded bits [N1, N2] (for validation)."""
    x = packed1[:, None, :] ^ packed2[None, :, :]
    return torch.sum((x[..., None] >> _shifts(x.device)) & 1, dim=(-1, -2)).to(torch.int32)


def hamming_top2_reference(packed1, packed2, valid2):
    """Plain version of the top-2 kernel: per set-1 row the best and second
    best distance to a valid set-2 column and the best column's index.

    packed1 [..., N1, 16], packed2 [..., N2, 16] int32, valid2 [..., N2] bool.
    Returns (best, second, idx) int32 [..., N1]. Ties go to the lowest
    index; a tie for best gives second == best; with no valid column best
    and second stay at SENTINEL and idx is 0 (``_match_descriptors_xla``)."""
    dist = hamming_matrix(packed1, packed2)
    sentinel = torch.tensor(SENTINEL, dtype=torch.int32, device=dist.device)
    dist = torch.where(valid2[..., None, :], dist, sentinel)
    best = torch.amin(dist, dim=-1)
    n2 = dist.shape[-1]
    cols = torch.arange(n2, dtype=torch.int32, device=dist.device)
    # lowest column attaining the minimum, spelled out rather than left to
    # argmin's tie rule
    idx = torch.amin(torch.where(dist == best[..., None], cols, n2), dim=-1)
    second = torch.amin(torch.where(cols == idx[..., None], sentinel, dist), dim=-1)
    return best, second, idx.to(torch.int32)


def finish_matches(best, second, idx, valid1, ratio: float = LOWE_RATIO):
    """Normalise by 486 and apply validity + the Lowe ratio test, in float32
    exactly as the reference does. Returns (idx2, distance, matched).

    The reference writes ``x / 486``; XLA compiles a division by a constant
    into a product with its float32 reciprocal, which rounds differently for
    about a third of the distances, so the product is written out here."""
    inv_bits = torch.tensor(1.0 / DESCRIPTOR_BITS, dtype=torch.float32, device=best.device)
    distance = best.to(torch.float32) * inv_bits
    second_f = second.to(torch.float32) * inv_bits
    ratio_f = torch.tensor(ratio, dtype=torch.float32, device=best.device)
    matched = valid1 & (best < SENTINEL) & (distance < ratio_f * second_f)
    return idx, distance, matched


def match_descriptors_reference(packed1, packed2, valid1, valid2, ratio: float = LOWE_RATIO):
    """Plain PyTorch twin of ``_match_descriptors_xla``: one-way matching with
    the Lowe ratio test, with an optional leading pair dim.

    packed1 [..., N1, 16], packed2 [..., N2, 16] int32; valid1 [..., N1],
    valid2 [..., N2] bool. Returns idx2 [..., N1] int32, distance [..., N1]
    float32 (bits / 486), matched [..., N1] bool."""
    best, second, idx = hamming_top2_reference(packed1, packed2, valid2)
    return finish_matches(best, second, idx, valid1, ratio)


def match_descriptors(packed1, packed2, valid1, valid2, ratio: float = LOWE_RATIO):
    """Match on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Same arguments and results as
    ``match_descriptors_reference``."""
    if packed1.device.type == "cuda":
        from opencalibration_tpu_torch.ops.hamming_cuda import hamming_top2

        best, second, idx = hamming_top2(packed1, packed2, valid2)
        return finish_matches(best, second, idx, valid1, ratio)
    if packed1.device.type == "cpu":
        return match_descriptors_reference(packed1, packed2, valid1, valid2, ratio)
    raise ValueError(f"no matcher for device {packed1.device}")


def sort_matches_descending(idx1, idx2, distance, matched):
    """Permutation ordering matches by descending distance, invalid last."""
    key = torch.where(matched, distance, -torch.inf)
    return torch.argsort(-key, stable=True)
