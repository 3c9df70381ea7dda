"""Inputs that hold the Hamming top-2 kernel against its plain version: the
edge cases of its contract and the main path's shapes, made on the CPU from a
numpy generator. ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``
both use them."""

from __future__ import annotations

import numpy as np
import torch

from opencalibration_tpu_torch.ops import hamming as H


def random_words(rng, shape, garbage_padding=False):
    """Packed descriptors as int32 bit patterns; with garbage_padding the 26
    bits above the 486 real ones are random too."""
    words = rng.integers(0, 2**32, size=tuple(shape) + (16,), dtype=np.uint64).astype(np.uint32)
    if not garbage_padding:
        words[..., 15] &= np.uint32((1 << 6) - 1)
    return torch.from_numpy(words.view(np.int32))


def flip_bits(rng, words, rate):
    """Copies of packed words with each of the 512 bits flipped at ``rate``."""
    flips = rng.random(tuple(words.shape) + (32,)) < rate
    mask = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64), axis=-1)
    return torch.from_numpy((words.numpy().view(np.uint32) ^ mask.astype(np.uint32)).view(np.int32))


def kernel_cases(rng):
    """[(name, packed1, packed2, valid1, valid2)] of the contract's edge cases."""
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
    p1 = random_words(rng, (96,))
    p2 = torch.cat([flip_bits(rng, p1[:48], 0.02), p1, p1])
    cases.append(("forced ties", p1, p2, ones(96), ones(p2.shape[0])))
    p1, p2 = random_words(rng, (70,)), random_words(rng, (90,))
    cases.append(("no valid column", p1, p2, ones(70), torch.zeros(90, dtype=torch.bool)))
    v2 = torch.zeros(90, dtype=torch.bool)
    v2[37] = True
    cases.append(("one valid column", p1, p2, ones(70), v2))
    p1 = random_words(rng, (150,), garbage_padding=True)
    p2 = torch.cat([flip_bits(rng, p1, 0.05), random_words(rng, (100,), garbage_padding=True)])
    cases.append(("garbage padding bits", p1, p2, ones(150), ones(250)))
    return cases


def split_ties_case(rng, n1=100, n2=1000):
    """One pair small enough that set 2 is split over several blocks (a
    single 128-row block), where every set-1 row has exact copies in two
    different 128-column tiles, and near copies in a third: ties for best
    across splits, and a second best from another split."""
    p1 = random_words(rng, (n1,), garbage_padding=True)
    p2 = random_words(rng, (n2,), garbage_padding=True)
    cols = rng.permutation(n2)
    first = [c for c in cols if c < 500][:n1]
    second = [c for c in cols if c >= 500][:n1]
    third = [c for c in cols if 250 <= c < 750 and c not in set(first) | set(second)][:n1]
    p2[torch.tensor(first)] = p1
    p2[torch.tensor(second)] = p1
    p2[torch.tensor(third)] = flip_bits(rng, p1, 0.01)
    v2 = torch.from_numpy(rng.random(n2) < 0.95)
    return p1, p2, torch.ones(n1, dtype=torch.bool), v2


def main_path_case(rng, pairs, n):
    """[pairs, n, 16] descriptors where 3/4 of set 2 are noisy copies of set 1
    in shuffled order, with some invalid rows on both sides."""
    p1 = random_words(rng, (pairs, n))
    p2 = random_words(rng, (pairs, n))
    m = 3 * n // 4
    for k in range(pairs):
        perm = torch.from_numpy(rng.permutation(n)[:m])
        p2[k, perm] = flip_bits(rng, p1[k, :m], 0.08)
    v1 = torch.from_numpy(rng.random((pairs, n)) < 0.97)
    v2 = torch.from_numpy(rng.random((pairs, n)) < 0.97)
    return p1, p2, v1, v2
