"""Parity of the port's batched-hypothesis RANSAC (homography) with the JAX
package.

The reference draws its [K, 4] sample uniforms from jax.random; the port
takes them as an input, so these tests hand it the reference's own draw
(float64 under the tests' x64 mode, used unrounded by both). With the same
samples, inlier masks must be equal and scores within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import ransac as JR
from opencalibration_tpu_torch.ops import ransac as TR
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

K = 512


def _scene(seed, n=300, outlier_rate=0.3, dtype=np.float32):
    """Unit-ray correspondences of a plane seen by two cameras, with
    outliers, a quality score (lower is better) and padded entries."""
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(-0.3, 0.3)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t = np.asarray([0.25, -0.1, 0.02])
    nrm = np.asarray([0.0, 0.0, 1.0])
    H = R + np.outer(t, nrm) / 3.0
    x1 = rng.uniform(-0.5, 0.5, size=(n, 2))
    h = np.concatenate([x1, np.ones((n, 1))], 1) @ H.T
    x2 = h[:, :2] / h[:, 2:] + rng.normal(scale=5e-4, size=(n, 2))
    outlier = rng.random(n) < outlier_rate
    x2[outlier] = rng.uniform(-0.5, 0.5, size=(outlier.sum(), 2))
    rays = []
    for x in (x1, x2):
        r = np.concatenate([x, np.ones((n, 1))], 1)
        rays.append((r / np.linalg.norm(r, axis=1, keepdims=True)).astype(dtype))
    quality = np.where(outlier, rng.uniform(0.2, 0.5, n), rng.uniform(0.0, 0.3, n)).astype(dtype)
    valid = np.ones(n, bool)
    valid[-20:] = False
    return rays[0], rays[1], quality, valid, ~outlier & valid


def _uniforms(seed=JR.DEFAULT_SEED):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (K, 4)))


def _port(args, **kw):
    return TR.ransac_homography_with_poses(*(torch.from_numpy(a) for a in args), num_hypotheses=K, **kw)


def test_sampler_equals_reference():
    r1, r2, quality, valid, _ = _scene(0)
    u = _uniforms()
    assert u.dtype == np.float64
    for has_q in (True, False):
        ref = JR._sample_hypotheses(jax.random.PRNGKey(JR.DEFAULT_SEED), jnp.asarray(quality),
                                    jnp.asarray(valid), K, 4, jnp.asarray(has_q))
        got = TR._sample_hypotheses(torch.from_numpy(u), torch.from_numpy(quality), torch.from_numpy(valid),
                                    K, 4, torch.tensor(has_q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_with_reference_uniforms(seed, dtype):
    args = _scene(seed, dtype=dtype)[:4]
    res_ref, quats_ref, ts_ref, scores_ref = JR.ransac_homography_with_poses(
        *(jnp.asarray(a) for a in args), num_hypotheses=K
    )
    res, quats, ts, scores = _port(args, uniforms=torch.from_numpy(_uniforms()))
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(res_ref.inliers))
    np.testing.assert_allclose(res.score.numpy(), np.asarray(res_ref.score), rtol=1e-5)
    np.testing.assert_allclose(res.model.numpy(), np.asarray(res_ref.model), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(scores_ref))
    np.testing.assert_allclose(quats.numpy(), np.asarray(quats_ref), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_ref), rtol=0, atol=1e-4)


def test_pair_batch_equals_per_pair():
    scenes = [_scene(s)[:4] for s in (3, 4, 5)]
    u = torch.from_numpy(_uniforms())
    batch = [np.stack([sc[i] for sc in scenes]) for i in range(4)]
    res_b, quats_b, ts_b, scores_b = _port(batch, uniforms=u)
    for k, sc in enumerate(scenes):
        res, quats, ts, scores = _port(sc, uniforms=u)
        assert torch.equal(res_b.inliers[k], res.inliers)
        torch.testing.assert_close(res_b.score[k], res.score, rtol=1e-6, atol=0)
        torch.testing.assert_close(quats_b[k], quats, rtol=0, atol=1e-5)
        torch.testing.assert_close(scores_b[k], scores, rtol=0, atol=0)


def test_port_sampler_recovers_inliers():
    """The port's own seeded draw: precision and recall of the inlier set
    against ground truth, as the reference's tests hold it."""
    r1, r2, quality, valid, truth = _scene(6)
    res, quats, ts, scores = _port((r1, r2, quality, valid))
    inl = res.inliers.numpy()
    precision = (inl & truth).sum() / max(inl.sum(), 1)
    recall = (inl & truth).sum() / truth.sum()
    assert precision >= 0.95 and recall >= 0.9, (precision, recall)
    # deterministic: the same seed gives the same result
    again = _port((r1, r2, quality, valid))[0]
    assert torch.equal(again.inliers, res.inliers)


def test_too_few_points_gives_empty_result():
    r1, r2, quality, valid, _ = _scene(7, n=3)
    res, quats, ts, scores = _port((r1, r2, quality, valid))
    assert torch.isnan(res.model).all() and not res.inliers.any() and float(res.score) == 0.0
