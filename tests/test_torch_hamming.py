"""Parity of the port's Hamming matching (opencalibration_tpu_torch.ops.hamming)
with the JAX package: packing, distance matrices and the plain matcher, which
is the CPU path of the CUDA top-2 kernel.

Every comparison is bit-exact: distances are integers, and the normalised
distance and Lowe test are the same float32 operations on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import hamming as JH
from opencalibration_tpu.ops.hamming_pallas import match_descriptors_pallas
from opencalibration_tpu_torch.ops import hamming as TH

BITS = JH.DESCRIPTOR_BITS


def _words(rng, n, garbage_padding=False):
    """[n, 16] uint32 descriptors; with garbage_padding the 26 bits above the
    486 real ones are random as well."""
    w = rng.integers(0, 2**32, size=(n, 16), dtype=np.uint64).astype(np.uint32)
    if not garbage_padding:
        w[:, 15] &= np.uint32((1 << 6) - 1)
    return w


def _noisy(rng, words, rate):
    """Copies of words with each of the 512 bits flipped at ``rate``."""
    flips = rng.random(words.shape + (32,)) < rate
    mask = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64), axis=-1)
    return words ^ mask.astype(np.uint32)


def _packed(rng, n):
    return np.asarray(JH.pack_bits(rng.integers(0, 2, size=(n, BITS)).astype(bool)))


def _case(name):
    """(packed1, packed2 uint32, valid1, valid2) for one named case."""
    rng = np.random.default_rng(CASES.index(name))
    ones = lambda n: np.ones(n, bool)  # noqa: E731
    if name == "agreement_200x300":  # tests/test_hamming_pallas.py cases
        return _packed(rng, 200), _packed(rng, 300), ones(200), ones(300)
    if name == "validity_64+64":
        p1 = _packed(rng, 64)
        p2 = np.concatenate([p1, _packed(rng, 64)])
        return p1, p2, ones(64), np.asarray([False] * 64 + [True] * 64)
    if name == "nonaligned_130x257":
        return _packed(rng, 130), _packed(rng, 257), ones(130), ones(257)
    if name == "correlated":  # most rows have a near copy: many pass Lowe
        p1 = _words(rng, 160)
        p2 = np.concatenate([_words(rng, 40), _noisy(rng, p1[:120], 0.06), _words(rng, 60)])
        v1 = rng.random(160) < 0.9
        return p1, p2, v1, rng.random(220) < 0.9
    if name == "ties":  # every row appears twice in set 2
        p1 = _words(rng, 48)
        p2 = np.concatenate([_noisy(rng, p1[:16], 0.03), p1, p1])
        return p1, p2, ones(48), ones(len(p2))
    if name == "no_valid_column":
        return _words(rng, 30), _words(rng, 50), ones(30), np.zeros(50, bool)
    if name == "one_valid_column":
        v2 = np.zeros(50, bool)
        v2[21] = True
        return _words(rng, 30), _words(rng, 50), ones(30), v2
    if name == "garbage_padding_bits":
        p1 = _words(rng, 90, garbage_padding=True)
        p2 = np.concatenate([_noisy(rng, p1, 0.05), _words(rng, 70, garbage_padding=True)])
        return p1, p2, ones(90), ones(160)
    raise KeyError(name)


CASES = [
    "agreement_200x300", "validity_64+64", "nonaligned_130x257", "correlated",
    "ties", "no_valid_column", "one_valid_column", "garbage_padding_bits",
]


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _port_match(p1, p2, v1, v2):
    out = TH.match_descriptors(_t(p1), _t(p2), torch.from_numpy(v1), torch.from_numpy(v2))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("n_bits", [486, 100, 64])
def test_pack_unpack_bit_exact(n_bits):
    bits = np.random.default_rng(n_bits).integers(0, 2, size=(3, 7, n_bits)).astype(bool)
    ref = np.asarray(JH.pack_bits(bits))
    got = TH.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TH.unpack_bits(_t(ref), n_bits).numpy(), bits)
    np.testing.assert_array_equal(
        TH.unpack_bits(_t(ref), n_bits).numpy(), np.asarray(JH.unpack_bits(jnp.asarray(ref), n_bits))
    )


def test_unpack_pm1_and_distance_matrices_bit_exact():
    rng = np.random.default_rng(3)
    p1, p2 = _words(rng, 40, garbage_padding=True), _words(rng, 55, garbage_padding=True)
    np.testing.assert_array_equal(
        TH._unpack_pm1(_t(p1), BITS).numpy(), np.asarray(JH._unpack_pm1(jnp.asarray(p1), BITS))
    )
    np.testing.assert_array_equal(
        TH.hamming_matrix(_t(p1), _t(p2)).numpy(),
        np.asarray(JH.hamming_matrix(jnp.asarray(p1), jnp.asarray(p2))),
    )
    # the popcount form counts every padded bit, garbage included
    np.testing.assert_array_equal(
        TH.hamming_matrix_popcount(_t(p1), _t(p2)).numpy(),
        np.asarray(JH.hamming_matrix_popcount(jnp.asarray(p1), jnp.asarray(p2))),
    )


@pytest.mark.parametrize("name", CASES)
def test_plain_matcher_equals_xla_path(name):
    p1, p2, v1, v2 = _case(name)
    ref = JH._match_descriptors_xla(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(v1), jnp.asarray(v2))
    got = _port_match(p1, p2, v1, v2)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", CASES)
def test_plain_matcher_equals_pallas_kernel(name):
    """Bit-exact with the TPU kernel run in interpret mode. With no valid
    set-2 column the Pallas kernel leaves its biased distance (~1e9 / 486)
    and an arbitrary column in place of the XLA path's sentinel and column
    0; there only ``matched`` (all False on both) is compared."""
    p1, p2, v1, v2 = _case(name)
    ref = match_descriptors_pallas(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(v1), jnp.asarray(v2), interpret=True
    )
    idx, dist, matched = _port_match(p1, p2, v1, v2)
    np.testing.assert_array_equal(matched, np.asarray(ref[2]))
    if v2.any():
        np.testing.assert_array_equal(idx, np.asarray(ref[0]))
        np.testing.assert_array_equal(dist, np.asarray(ref[1]))
    else:
        assert not matched.any()


def test_edge_case_contract():
    """Ties go to the lowest index with second == best; no valid column
    gives the sentinel and no match; one valid column passes Lowe."""
    p1, p2, v1, v2 = _case("ties")
    best, second, idx = (x.numpy() for x in TH.hamming_top2_reference(_t(p1), _t(p2), torch.from_numpy(v2)))
    np.testing.assert_array_equal(second[16:], best[16:])
    assert (idx[16:] == 16 + np.arange(16, 48)).all() and (best[16:] == 0).all()
    _, _, matched = _port_match(p1, p2, v1, v2)
    assert not matched[16:].any()

    p1, p2, v1, v2 = _case("no_valid_column")
    best, second, idx = (x.numpy() for x in TH.hamming_top2_reference(_t(p1), _t(p2), torch.from_numpy(v2)))
    assert (best == TH.SENTINEL).all() and (second == TH.SENTINEL).all() and (idx == 0).all()

    p1, p2, v1, v2 = _case("one_valid_column")
    idx, _, matched = _port_match(p1, p2, v1, v2)
    assert matched.all() and (idx == 21).all()


def test_pair_batch_equals_per_pair():
    cases = [_case(n) for n in ("correlated", "ties")]
    n1 = min(c[0].shape[0] for c in cases)
    n2 = min(c[1].shape[0] for c in cases)
    b = [np.stack([c[i][: (n1 if i in (0, 2) else n2)] for c in cases]) for i in range(4)]
    got = TH.match_descriptors(_t(b[0]), _t(b[1]), torch.from_numpy(b[2]), torch.from_numpy(b[3]))
    for k in range(len(cases)):
        one = _port_match(b[0][k], b[1][k], b[2][k], b[3][k])
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[k].numpy(), o)


def test_sort_matches_descending_equal():
    rng = np.random.default_rng(7)
    dist = rng.integers(0, 50, 64).astype(np.float32) / 486.0  # with ties
    matched = rng.random(64) < 0.7
    idx = np.arange(64, dtype=np.int32)
    ref = JH.sort_matches_descending(idx, idx, jnp.asarray(dist), jnp.asarray(matched))
    got = TH.sort_matches_descending(None, None, torch.from_numpy(dist), torch.from_numpy(matched))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
