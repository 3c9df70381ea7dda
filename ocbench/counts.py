"""Work counts and the card's peaks: the yardstick of every roofline share.

A frozen copy of ``hamming_ops``, ``hamming_top2_bytes``,
``hamming_top2_bound`` and the H100 peaks of
opencalibration_tpu_torch/bench/bench_kernels.py at commit
3a365f3897db20a853d4aa1c09f57b88461614aa. The counts are of the work the
inputs need, whatever implements it: a Hamming distance between two 486-bit
descriptors is 486 multiply-adds (the words' padding to 512 bits is the
implementation's); bytes are each input read once and each output written
once.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores
H100_INT8_OPS = 1979e12  # int8 tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

DESCRIPTOR_BITS = 486
DESCRIPTOR_WORDS = 16  # the packed int32 words a descriptor is passed in


def hamming_ops(pairs: int, n1: int, n2: int) -> int:
    """A multiply-add per descriptor bit and distance: 2 P N1 N2 486."""
    return 2 * pairs * n1 * n2 * DESCRIPTOR_BITS


def hamming_top2_bytes(pairs: int, n1: int, n2: int) -> int:
    """Inputs (both sets' packed words, valid2 as bytes) and the three int32
    results (best, second, index) per set-1 row."""
    return pairs * ((n1 + n2) * 4 * DESCRIPTOR_WORDS + n2 + 3 * 4 * n1)


def hamming_top2_bound(pairs: int, n1: int, n2: int):
    """The least seconds one launch at [pairs, n1, n2] can take on the int8
    tensor cores, and what bounds it: (seconds, "operations" | "bytes")."""
    t_ops = hamming_ops(pairs, n1, n2) / H100_INT8_OPS
    t_bytes = hamming_top2_bytes(pairs, n1, n2) / H100_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or "" where
    it cannot: a card below 700 W runs slower than its data sheet."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
