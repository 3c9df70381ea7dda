"""Parity of the port's Gaussian-path feature extraction
(opencalibration_tpu_torch.ops.features) with the JAX package.

The JAX side runs in its float32 blur mode (the port has no bfloat16 blur);
the prior mode is restored after the module. Tolerances: blurs 1e-6 absolute
on [0, 1] images (float32 sums in another order), Hessian responses 1e-5 of
the response's largest magnitude, keypoints within 0.01 px, descriptors bit
for bit on nearly all bits (a comparison of two samples that differ by float
rounding may flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import features as JF
from opencalibration_tpu_torch.ops import features as TF
from tests.synthetic_survey import make_texture

MAX_FEATURES = 512


@pytest.fixture(scope="module", autouse=True)
def f32_blur():
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    yield
    JF.set_blur_precision(prior)


@pytest.fixture(scope="module")
def images():
    """[3, 240, 320] float32 crops of the survey texture, one shifted by a
    sub-image offset so the views overlap."""
    tex = make_texture(0)
    crops = [tex[0:240, 0:320], tex[40:280, 60:380], tex[200:440, 150:470]]
    return np.stack(crops).astype(np.float32)


@pytest.fixture(scope="module")
def jax_features(images):
    return {k: np.asarray(v) for k, v in JF.extract_features(jnp.asarray(images), MAX_FEATURES).items()}


@pytest.fixture(scope="module")
def port_features(images):
    return {k: v.numpy() for k, v in TF.extract_features(torch.from_numpy(images), MAX_FEATURES).items()}


@pytest.mark.parametrize("sigma", [1.0, 1.6, 2.3, 3.7])
def test_blur_equals_toeplitz_product(images, sigma):
    ref = np.asarray(JF._blur(jnp.asarray(images), sigma))
    got = TF._blur(torch.from_numpy(images), sigma).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_blur_levels_and_hessian_response(images):
    rels = [TF.BASE_SIGMA * 2.0 ** (s / TF.SUBLEVELS) for s in range(TF.SUBLEVELS)]
    base = np.asarray(JF._blur(jnp.asarray(images), TF.BASE_SIGMA))
    L_ref = np.asarray(JF._blur_levels(jnp.asarray(base), TF.BASE_SIGMA, rels))
    L = TF._blur_levels(torch.from_numpy(base), TF.BASE_SIGMA, rels)
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=0, atol=1e-6)

    sig = np.asarray(rels, np.float32)
    R_ref = np.asarray(JF.hessian_response(jnp.asarray(L_ref), jnp.asarray(sig)))
    scale = np.abs(R_ref).max()
    # the same levels in: the two convolution forms
    R_same = TF.hessian_response(torch.from_numpy(L_ref), torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(R_same, R_ref, rtol=0, atol=1e-5 * scale)
    # the port's own chain from the pixels
    R_own = TF.hessian_response(L, torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(R_own, R_ref, rtol=0, atol=1e-5 * scale)


def test_derivative_convolutions(images):
    img = jnp.asarray(images)
    for k in (JF._DX, JF._DY):
        np.testing.assert_allclose(TF._conv3(torch.from_numpy(images), np.asarray(k)).numpy(),
                                   np.asarray(JF._conv3(img, k)), rtol=0, atol=1e-6)
    kernels = np.stack([np.asarray(JF._DX), np.asarray(JF._DY)])[:, None]
    np.testing.assert_allclose(
        TF._conv3_multi(torch.from_numpy(images)[:, None], torch.from_numpy(kernels)).numpy(),
        np.asarray(JF._conv3_multi(img[:, None], jnp.asarray(kernels))), rtol=0, atol=1e-6,
    )


def test_top_k_order_matches_lax_top_k():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, size=(4, 300)).astype(np.float32)  # many ties
    x[0, :200] = -np.inf
    for k in (1, 17, 150):
        vals, idx = jax.lax.top_k(jnp.asarray(x), k)
        got_vals, got_idx = TF._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_vals.numpy(), np.asarray(vals))


def test_candidates_from_same_responses_are_identical(images):
    """NMS, top-k and the subpixel fit on one response stack."""
    rels = [TF.BASE_SIGMA * 2.0 ** (s / TF.SUBLEVELS) for s in range(TF.SUBLEVELS)]
    base = JF._blur(jnp.asarray(images), TF.BASE_SIGMA)
    Lo = JF._blur_levels(base, TF.BASE_SIGMA, rels)
    Rb = np.asarray(jnp.transpose(JF.hessian_response(Lo, jnp.asarray(rels, jnp.float32)), (1, 0, 2, 3)))
    ref = JF._candidates_from_levels(jnp.asarray(Rb), TF.DETECTOR_THRESHOLD, 16, 256, 1.0)
    got = TF._candidates_from_levels(torch.from_numpy(Rb), TF.DETECTOR_THRESHOLD, 16, 256, 1.0)
    xy, vals, lvl, valid = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), lvl)
    np.testing.assert_array_equal(got[1].numpy(), vals)
    np.testing.assert_allclose(got[0].numpy(), xy, rtol=0, atol=1e-4)


def _nearest(xy_ref, xy):
    d = np.linalg.norm(xy_ref[:, None, :] - xy[None, :, :], axis=-1)
    return d.argmin(axis=1), d.min(axis=1)


def test_keypoint_sets_agree(jax_features, port_features):
    """>= 95% of the reference's valid keypoints have a port keypoint within
    0.01 px (near-threshold responses may reorder the tail of top-k)."""
    for b in range(jax_features["xy"].shape[0]):
        ref_xy = jax_features["xy"][b][jax_features["valid"][b]]
        xy = port_features["xy"][b][port_features["valid"][b]]
        _, dist = _nearest(ref_xy, xy)
        rate = float(np.mean(dist < 0.01))
        print(f"image {b}: {len(ref_xy)} reference keypoints, {len(xy)} port, {rate:.4f} within 0.01 px")
        assert rate >= 0.95


def test_descriptors_agree_on_matched_keypoints(jax_features, port_features):
    """Descriptors of keypoints matched within 0.01 px agree on >= 99% of
    bits; the agreement rate is printed."""
    from opencalibration_tpu.ops.hamming import unpack_bits

    same = total = 0
    for b in range(jax_features["xy"].shape[0]):
        v_ref, v = jax_features["valid"][b], port_features["valid"][b]
        j, dist = _nearest(jax_features["xy"][b][v_ref], port_features["xy"][b][v])
        ok = dist < 0.01
        bits_ref = np.asarray(unpack_bits(jnp.asarray(jax_features["descriptors"][b][v_ref][ok])))
        bits = np.asarray(unpack_bits(jnp.asarray(port_features["descriptors"][b][v][j[ok]].view(np.uint32))))
        same += int((bits == bits_ref).sum())
        total += bits.size
    rate = same / total
    print(f"descriptor bit agreement on matched keypoints: {rate:.6f} of {total} bits")
    assert rate >= 0.99


def test_describe_on_reference_keypoints(images, jax_features):
    """The port's describe() fed the reference's keypoints."""
    det = {k: jax_features[k] for k in ("xy", "sigma")}
    desc_ref = jax_features["descriptors"]
    desc, angle = TF.describe(torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in det.items()})
    np.testing.assert_allclose(angle.numpy(), jax_features["angle"], rtol=0, atol=1e-4)
    diff = np.unpackbits((desc.numpy().view(np.uint32) ^ desc_ref).view(np.uint8)).sum()
    rate = 1.0 - diff / (desc_ref.size * 32)
    print(f"descriptor bit agreement on the reference's keypoints: {rate:.6f}")
    assert rate >= 0.999


def test_uint8_input_normalised_like_float(images):
    u8 = np.round(images * 255).astype(np.uint8)
    got = TF.extract_features(torch.from_numpy(u8), 128)
    want = TF.extract_features(torch.from_numpy(u8).to(torch.float32) / 255.0, 128)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_bilinear_and_cell_layout_equal():
    rng = np.random.default_rng(4)
    img = rng.random((20, 30)).astype(np.float32)
    x = rng.uniform(-2, 33, 50).astype(np.float32)
    y = rng.uniform(-2, 23, 50).astype(np.float32)
    np.testing.assert_allclose(
        TF._bilinear(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JF._bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))),
        rtol=0, atol=1e-6,
    )
    centers, pairs = TF._mldb_cell_centers()
    np.testing.assert_array_equal(centers, np.asarray(JF._CELL_CENTERS))
    np.testing.assert_array_equal(pairs, np.asarray(JF._CELL_PAIRS))
