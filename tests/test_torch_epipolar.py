"""Parity of the port's epipolar models and of RANSAC for "essential" and
"fundamental" (with DEGENSAC) with the JAX package, on the cases of
tests/test_ransac.py: the fundamental matrix on the clean scene, with 30 %
outliers and with 85 % of the inliers on one plane, the essential matrix on
the clean scene. (An essential hypothesis from 5 points is the smallest
eigenvector of a rank-5 9 x 9 system, so any vector of a 4-dimensional null
space: the two eigen solvers pick different ones, and on a scene with
outliers the hypotheses, not only their signs, differ.)

The reference draws its [K, S] sample uniforms from jax.random; the port
takes the same uniforms as an input (float64 under the tests' x64 mode). An
eigenvector's sign is the eigen solver's choice, so models are compared up to
sign: within 1e-6 of the reference's after both are scaled to unit norm and
the sign of their largest entry. Inlier masks equal; scores within 1e-9
relative; DEGENSAC's decision equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import models as JM
from opencalibration_tpu.ops import ransac as JR
from opencalibration_tpu_torch.ops import models as TM
from opencalibration_tpu_torch.ops import ransac as TR
from tests.test_ransac import fundamental_scene, precision_recall
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 1024
MODEL_TOL = 1e-6
SCORE_REL = 1e-9

SCENES = {  # the cases of tests/test_ransac.py
    "clean": dict(n_inliers=200, n_outliers=0),
    "outliers": dict(n_inliers=200, n_outliers=86, seed=21),
    "planar": dict(n_inliers=200, n_outliers=40, planar_fraction=0.85, seed=33),
}


def _canonical(m):
    """Scaled to unit norm, the largest-magnitude entry positive."""
    m = np.asarray(m, np.float64).reshape(-1)
    m = m / np.linalg.norm(m)
    return m * np.sign(m[np.argmax(np.abs(m))])


def _assert_same_model(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_canonical(got), _canonical(want), rtol=0, atol=tol)


def _uniforms(min_points, seed=JR.DEFAULT_SEED):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (K, min_points)))


@pytest.mark.parametrize("model_type, scene", [("fundamental", "clean"), ("fundamental", "outliers"),
                                               ("fundamental", "planar"), ("essential", "clean")])
def test_ransac_with_reference_uniforms(model_type, scene):
    _, m1, m2, gt = fundamental_scene(**SCENES[scene])
    n = m1.shape[0]
    ref = JR.ransac(jnp.asarray(m1), jnp.asarray(m2), jnp.zeros(n), jnp.ones(n, bool), model_type,
                    num_hypotheses=K)
    min_points = TR._MODELS[model_type].min_points
    got = TR.ransac(torch.from_numpy(m1), torch.from_numpy(m2), torch.zeros(n, dtype=torch.float64),
                    torch.ones(n, dtype=torch.bool), model_type, num_hypotheses=K,
                    uniforms=torch.from_numpy(_uniforms(min_points)))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=SCORE_REL)
    _assert_same_model(got.model.numpy(), ref.model)
    prec, rec = precision_recall(got.inliers.numpy(), gt)
    assert prec >= 0.8 and rec >= 0.6


def test_degensac_decision_matches_reference():
    """DEGENSAC on the planar scene's best fundamental matrix, and on a
    matrix it must keep (the clean scene's), with the decision equal."""
    for scene, expect_used in (("planar", None), ("clean", False)):
        F, m1, m2, _ = fundamental_scene(**SCENES[scene])
        p1, p2 = m1[:, :2] / m1[:, 2:], m2[:, :2] / m2[:, 2:]
        n = p1.shape[0]
        valid = np.ones(n, bool)
        thr = JM.FUNDAMENTAL_INLIER_THRESHOLD
        err = np.asarray(JM.epipolar_error(jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2)))
        inliers = err < thr
        score = float(np.sum(np.where(inliers, 1 - (err / thr) ** 2, 0.0)))
        ref = JR._fundamental_degensac(jnp.asarray(F), jnp.asarray(score), jnp.asarray(inliers), jnp.asarray(p1),
                                       jnp.asarray(p2), jnp.asarray(valid), thr)
        got = TR._fundamental_degensac(*(torch.from_numpy(np.asarray(a)) for a in (F, score, inliers, p1, p2, valid)),
                                       thr)
        used = not np.array_equal(np.asarray(ref[0]), F)
        assert bool(got[3]) == used
        if expect_used is not None:
            assert used == expect_used
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        _assert_same_model(got[0].numpy(), ref[0])


@pytest.mark.parametrize("kind", ["essential", "fundamental"])
def test_fits_error_and_decomposition_match_reference(kind):
    F, m1, m2, _ = fundamental_scene(60, 0, seed=4)
    p1, p2 = m1[:, :2], m2[:, :2]
    rng = np.random.default_rng(5)
    w = rng.uniform(0.2, 1.0, p1.shape[0])
    jfit, jfitw = getattr(JM, f"{kind}_fit"), getattr(JM, f"{kind}_fit_weighted")
    tfit, tfitw = getattr(TM, f"{kind}_fit"), getattr(TM, f"{kind}_fit_weighted")
    t1, t2, tw = torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(w)
    _assert_same_model(tfit(t1, t2).numpy(), jfit(jnp.asarray(p1), jnp.asarray(p2)))
    model = tfitw(t1, t2, tw)
    ref = jfitw(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    _assert_same_model(model.numpy(), ref)
    # the error is invariant to the model's sign: compare on one model
    np.testing.assert_allclose(TM.epipolar_error(model, t1, t2).numpy(),
                               np.asarray(JM.epipolar_error(jnp.asarray(model.numpy()), jnp.asarray(p1),
                                                            jnp.asarray(p2))), rtol=1e-9, atol=1e-15)
    # a batch of minimal samples in one call equals one call each: the
    # reference's for the 8-point fundamental; for the 5-point essential the
    # port's own (its null space is 4-dimensional, see the module docstring)
    s = TR._MODELS[kind].min_points
    idx = np.stack([rng.choice(p1.shape[0], s, replace=False) for _ in range(6)])
    batched = tfit(t1[idx], t2[idx])
    for k in range(6):
        if kind == "fundamental":
            _assert_same_model(batched[k].numpy(), jfit(jnp.asarray(p1[idx[k]]), jnp.asarray(p2[idx[k]])))
        else:
            _assert_same_model(batched[k].numpy(), tfit(t1[idx[k]], t2[idx[k]]).numpy())
    if kind == "essential":
        e = model.numpy()
        R, t = TM.essential_decompose(model)
        jR, jt = JM.essential_decompose(jnp.asarray(e))
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-9)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-9)


def test_non_finite_samples_give_non_finite_models():
    p = torch.full((8, 2), float("nan"), dtype=torch.float64)
    assert not torch.isfinite(TM.fundamental_fit(p, p)).any()
    assert not torch.isfinite(TM.essential_fit(p[:5], p[:5])).any()
