"""The port's hand-written CUDA kernel against its plain PyTorch version.

Tests marked ``gpu`` need a CUDA device and skip without one; the device is
looked up inside a fixture, so every worker collects the same tests. This
file imports no JAX, so it also runs on a machine without the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) The unmarked
tests check the dispatch rules and run anywhere.
"""

import numpy as np
import pytest
import torch

from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import hamming_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, garbage_padding=True):
    w = rng.integers(0, 2**32, size=shape + (16,), dtype=np.uint64).astype(np.uint32)
    if not garbage_padding:
        w[..., 15] &= np.uint32((1 << 6) - 1)
    return torch.from_numpy(w.view(np.int32))


def _near_copies(rng, words, rate):
    flips = rng.random(tuple(words.shape) + (32,)) < rate
    mask = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64), axis=-1)
    return torch.from_numpy((words.numpy().view(np.uint32) ^ mask.astype(np.uint32)).view(np.int32))


def _inputs(seed, pairs, n1, n2, valid_rate):
    """Descriptors where half of set 2 are near copies of set 1 (so rows pass
    the Lowe test), with invalid rows and garbage padding bits."""
    rng = np.random.default_rng(seed)
    shape1 = (n1,) if pairs is None else (pairs, n1)
    shape2 = (n2,) if pairs is None else (pairs, n2)
    p1, p2 = _words(rng, shape1), _words(rng, shape2)
    k = min(n1, n2) // 2
    p2[..., :k, :] = _near_copies(rng, p1[..., :k, :], 0.05)
    v1 = torch.from_numpy(rng.random(shape1) < 0.95)
    v2 = torch.from_numpy(rng.random(shape2) < valid_rate)
    return p1, p2, v1, v2


@pytest.mark.gpu
@pytest.mark.parametrize(
    "pairs,n1,n2,valid_rate",
    [
        (None, 200, 300, 1.0),
        (None, 130, 257, 0.9),
        (None, 1, 1, 1.0),
        (None, 64, 90, 0.0),  # no valid column
        (3, 129, 127, 0.9),
        (42, 2048, 2048, 0.97),  # the calibration main path
    ],
)
def test_kernel_bit_exact_with_plain_version(cuda, pairs, n1, n2, valid_rate):
    p1, p2, v1, v2 = (t.to(cuda) for t in _inputs(n1 + n2, pairs, n1, n2, valid_rate))
    before = hamming_cuda.hamming_top2.launches
    got = hamming_cuda.hamming_top2(p1, p2, v2) + H.match_descriptors(p1, p2, v1, v2)
    want = H.hamming_top2_reference(p1, p2, v2) + H.match_descriptors_reference(p1, p2, v1, v2)
    torch.cuda.synchronize()
    assert hamming_cuda.hamming_top2.launches == before + 2
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernel_one_valid_column_passes_lowe(cuda):
    p1, p2, v1, _ = (t.to(cuda) for t in _inputs(5, None, 40, 60, 1.0))
    v2 = torch.zeros(60, dtype=torch.bool, device=cuda)
    v2[33] = True
    idx, _, matched = H.match_descriptors(p1, p2, v1, v2)
    assert torch.equal(matched, v1) and bool((idx == 33).all())


@pytest.mark.gpu
def test_kernel_refuses_bad_inputs(cuda):
    p1, p2, _, v2 = (t.to(cuda) for t in _inputs(6, 2, 32, 48, 1.0))
    with pytest.raises(TypeError):
        hamming_cuda.hamming_top2(p1.to(torch.int64), p2, v2)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_top2(p1[..., :8], p2, v2)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_top2(p1.transpose(0, 1), p2, v2)


def test_wrapper_refuses_cpu_tensors():
    p1, p2, _, v2 = _inputs(7, None, 8, 9, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        hamming_cuda.hamming_top2(p1, p2, v2)


def test_cpu_tensors_take_the_plain_version():
    p1, p2, v1, v2 = _inputs(8, 2, 50, 70, 0.9)
    before = hamming_cuda.hamming_top2.launches
    got = H.match_descriptors(p1, p2, v1, v2)
    want = H.match_descriptors_reference(p1, p2, v1, v2)
    assert hamming_cuda.hamming_top2.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
