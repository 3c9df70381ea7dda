"""The frozen counts against hand counts, and against the program's twin."""

import pytest

from ocbench import counts


@pytest.mark.parametrize("p, n1, n2", [(1, 1, 1), (16, 1024, 1024), (42, 2048, 2048), (3, 5, 7)])
def test_hamming_ops_is_a_multiply_add_per_bit_and_distance(p, n1, n2):
    assert counts.hamming_ops(p, n1, n2) == 2 * p * n1 * n2 * 486


def test_link_chunk_bound_by_hand():
    ops = 2 * 16 * 1024 * 1024 * 486
    nbytes = 16 * ((1024 + 1024) * 64 + 1024 + 12 * 1024)
    assert counts.hamming_top2_bytes(16, 1024, 1024) == nbytes
    seconds, by = counts.hamming_top2_bound(16, 1024, 1024)
    assert by == "operations"
    assert seconds == pytest.approx(ops / 1979e12)
    assert nbytes / 3.35e12 < seconds


def test_small_launch_is_bound_by_bytes():
    assert counts.hamming_top2_bound(1, 1, 1)[1] == "bytes"


def test_frozen_copy_agrees_with_the_programs_twin():
    from opencalibration_tpu_torch.bench import bench_kernels as BK

    for shape in [(16, 1024, 1024), (42, 2048, 2048), (1, 4096, 4096)]:
        assert counts.hamming_ops(*shape) == BK.hamming_ops(*shape)
        assert counts.hamming_top2_bytes(*shape) == BK.hamming_top2_bytes(*shape)
        ms, by = BK.hamming_top2_bound(*shape)
        assert counts.hamming_top2_bound(*shape) == (pytest.approx(ms * 1e-3), by)
