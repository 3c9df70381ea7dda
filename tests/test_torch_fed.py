"""Parity of the port's nonlinear (``fed``) scale space and extraction
(``ops.features.scale_space(..., "fed")``, ``extract_features(...,
diffusion="fed")``) with the JAX package.

The JAX side runs in its float32 blur mode (its default bfloat16 blur is a
different chain, ROADMAP 3b); the prior mode is restored after the module.
The two packages' blurs sum in another order (up to 4 ulp, 3b), and about a
thousand explicit diffusion steps carry that along. Tolerances: the contrast
factor k within 1e-6 relative; every level within 1e-5 of the [0, 1] range;
keypoints: equal counts, at least 99 % within 0.01 px, descriptors equal on
at least 99.5 % of the bits of the keypoints that agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import features as JF
from opencalibration_tpu_torch.ops import features as TF
from tests.synthetic_survey import make_texture
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_FEATURES = 256
LEVEL_ABS = 1e-5
K_REL = 1e-6
XY_PX, XY_SHARE = 0.01, 0.99
BIT_SHARE = 0.995


@pytest.fixture(scope="module", autouse=True)
def f32_blur():
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    yield
    JF.set_blur_precision(prior)


@pytest.fixture(scope="module")
def images():
    """[2, 120, 160] float32 crops of the survey texture that overlap."""
    tex = make_texture(0)
    return np.stack([tex[0:120, 0:160], tex[30:150, 40:200]]).astype(np.float32)


def test_scale_space_matches_reference(images):
    ref_L, ref_s = JF.scale_space(jnp.asarray(images), "fed")
    got_L, got_s = TF.scale_space(torch.from_numpy(images), "fed")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-7)
    assert got_L.shape == ref_L.shape
    np.testing.assert_allclose(got_L.numpy(), np.asarray(ref_L), rtol=0, atol=LEVEL_ABS)
    # the Gaussian form of the same function, which the detector's octave
    # pyramid does not use
    ref_g = np.asarray(JF.scale_space(jnp.asarray(images), "gaussian")[0])
    np.testing.assert_allclose(TF.scale_space(torch.from_numpy(images), "gaussian")[0].numpy(), ref_g,
                               rtol=0, atol=LEVEL_ABS)


def test_contrast_percentile_and_steps_match_reference(images):
    g = np.abs(np.random.default_rng(3).normal(size=(2, 5001))).astype(np.float32)
    ref = np.asarray(jnp.percentile(jnp.asarray(g), 70.0, axis=1))
    got = TF._percentile(torch.from_numpy(g), 70.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=K_REL)
    for total in (0.1, 0.24, 1.0, 37.3):
        assert TF._fed_tau_cycle(total) == JF._fed_tau_cycle(total)
    c = np.random.default_rng(4).uniform(0.1, 1.0, images.shape).astype(np.float32)
    ref_step = np.asarray(JF._diffusion_step(jnp.asarray(images), jnp.asarray(c), 0.2))
    got_step = TF._diffusion_step(torch.from_numpy(images), torch.from_numpy(c), 0.2).numpy()
    np.testing.assert_allclose(got_step, ref_step, rtol=0, atol=1e-7)


def test_extract_features_fed_matches_reference(images):
    ref = {k: np.asarray(v) for k, v in
           JF.extract_features(jnp.asarray(images), MAX_FEATURES, diffusion="fed").items()}
    got = {k: v.numpy() for k, v in
           TF.extract_features(torch.from_numpy(images), MAX_FEATURES, diffusion="fed").items()}
    np.testing.assert_array_equal(got["valid"].sum(1), ref["valid"].sum(1))
    assert ref["valid"].sum() > 50
    close = np.all(np.abs(got["xy"] - ref["xy"]) <= XY_PX, axis=-1) & ref["valid"]
    assert close.sum() >= XY_SHARE * ref["valid"].sum()
    bits_got = np.unpackbits(got["descriptors"][close].view(np.uint8))
    bits_ref = np.unpackbits(ref["descriptors"][close].astype(np.uint32).view(np.uint8))
    assert np.mean(bits_got == bits_ref) >= BIT_SHARE
    np.testing.assert_array_equal(got["level"][close], ref["level"][close])
    np.testing.assert_allclose(got["sigma"][close], ref["sigma"][close], rtol=1e-7)


def test_unknown_diffusion_raises(images):
    with pytest.raises(ValueError, match="diffusion"):
        TF.scale_space(torch.from_numpy(images), "pm1")
