"""Parity of the port's camera container, quaternion algebra, projection /
distortion and homography models with the JAX package.

Tolerances: 1e-6 absolute in float64 and 1e-4 in float32 (the same formulas
with sums and fused operations in another order). Homography decompositions
are compared as sets of candidates, since the SVD fixes neither the order nor
the signs of its singular vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import distort as JD
from opencalibration_tpu.ops import models as JM
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.types import camera as JC
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops import distort as TD
from opencalibration_tpu_torch.ops import models as TM
from opencalibration_tpu_torch.ops import quaternion as TQ
from opencalibration_tpu_torch.types import camera as TC
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float64": (np.float64, torch.float64, 1e-6), "float32": (np.float32, torch.float32, 1e-4)}


def _close(got, ref, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)


def _unit_quats(rng, n, dtype):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(dtype)


def test_camera_model_create_stack_take():
    kw = dict(principal_point=(160.0, 120.0), radial_distortion=(0.1, -0.02, 0.003),
              tangential_distortion=(1e-3, -2e-3), pixels_cols=320, pixels_rows=240)
    cams_ref = [JC.CameraModel.create(f, **kw, dtype=jnp.float64) for f in (400.0, 410.0, 390.0)]
    cams = [TC.CameraModel.create(f, **kw, dtype=torch.float64, device="cpu") for f in (400.0, 410.0, 390.0)]
    stacked_ref, stacked = JC.stack_cameras(cams_ref), TC.stack_cameras(cams)
    for k in TC.LEAVES:
        _close(getattr(stacked, k), getattr(stacked_ref, k), 0)
        _close(getattr(TC.take_camera(stacked, 1), k), getattr(JC.take_camera(stacked_ref, 1), k), 0)
    assert stacked.tag == stacked_ref.tag == TC.FORWARD
    assert bool(cams[0].has_distortion()) and bool(cams_ref[0].has_distortion())
    assert cams[0].astype(torch.float32).dtype == torch.float32
    with pytest.raises(ValueError):
        TC.stack_cameras([cams[0], cams[1].with_tag(TC.INVERSE)])


@pytest.mark.parametrize("dt", DTYPES)
def test_quaternion_functions(dt):
    npd, _, atol = DTYPES[dt]
    rng = np.random.default_rng(0)
    q, r = _unit_quats(rng, 32, npd), _unit_quats(rng, 32, npd)
    q_raw = (q * rng.uniform(0.5, 2.0, (32, 1))).astype(npd)
    v = rng.normal(size=(32, 3)).astype(npd)
    small = (rng.normal(size=(32, 3)) * np.logspace(-9, 0, 32)[:, None]).astype(npd)
    ang = rng.uniform(-3, 3, 32).astype(npd)
    n1 = v / np.linalg.norm(v, axis=1, keepdims=True)
    n2 = np.roll(n1, 1, axis=0)
    J = lambda x: jnp.asarray(x)  # noqa: E731  jnp path of the polymorphic reference
    T = torch.from_numpy  # noqa: N806
    cases = [
        (TQ.quat_identity(T(q).dtype, device="cpu"), JQ.quat_identity(q.dtype)),
        (TQ.quat_normalize(T(q_raw)), JQ.quat_normalize(J(q_raw))),
        (TQ.quat_conjugate(T(q)), JQ.quat_conjugate(J(q))),
        (TQ.quat_inverse(T(q_raw)), JQ.quat_inverse(J(q_raw))),
        (TQ.quat_multiply(T(q), T(r)), JQ.quat_multiply(J(q), J(r))),
        (TQ.quat_rotate(T(q), T(v)), JQ.quat_rotate(J(q), J(v))),
        (TQ.quat_rotate_inverse(T(q), T(v)), JQ.quat_rotate_inverse(J(q), J(v))),
        (TQ.quat_from_axis_angle(T(v), T(ang)), JQ.quat_from_axis_angle(J(v), J(ang))),
        (TQ.quat_exp(T(small)), JQ.quat_exp(J(small))),
        (TQ.quat_log(T(q)), JQ.quat_log(J(q))),
        (TQ.quat_angle(T(q)), JQ.quat_angle(J(q))),
        (TQ.quat_to_matrix(T(q)), JQ.quat_to_matrix(J(q))),
        (TQ.quat_from_matrix(TQ.quat_to_matrix(T(q))), JQ.quat_from_matrix(JQ.quat_to_matrix(J(q)))),
        (TQ.quat_boxplus(T(q), T(small)), JQ.quat_boxplus(J(q), J(small))),
        (TQ.angle_between_unit_vectors(T(n1), T(n2)), JQ.angle_between_unit_vectors(J(n1), J(n2))),
    ]
    assert len(cases) == 15
    for got, ref in cases:
        assert got.dtype == T(np.asarray(ref)).dtype
        _close(got, ref, atol)


def test_quaternion_jacobian_matches_jax():
    """The LM differentiates through boxplus, rotation and angles."""
    q0 = _unit_quats(np.random.default_rng(1), 1, np.float64)[0]
    v = np.asarray([0.3, -0.2, 0.9])

    def f_ref(d):
        q = JQ.quat_normalize(JQ.quat_boxplus(jnp.asarray(q0), d))
        return jnp.concatenate([JQ.quat_rotate_inverse(q, jnp.asarray(v)), JQ.quat_angle(q)[None]])

    def f(d):
        q = TQ.quat_normalize(TQ.quat_boxplus(torch.from_numpy(q0), d))
        return torch.cat([TQ.quat_rotate_inverse(q, torch.from_numpy(v)), TQ.quat_angle(q)[None]])

    J_ref = jax.jacfwd(f_ref)(jnp.zeros(3))
    J = torch.func.jacfwd(f)(torch.zeros(3, dtype=torch.float64))
    assert J.dtype == torch.float64
    _close(J, J_ref, 1e-9)


def _camera_pair(tag, dt):
    kw = dict(principal_point=(162.0, 118.0), radial_distortion=(-0.08, 0.02, -0.003),
              tangential_distortion=(4e-4, -3e-4), pixels_cols=320, pixels_rows=240, tag=tag)
    return (JC.CameraModel.create(400.0, **kw, dtype=DTYPES[dt][0]),
            TC.CameraModel.create(400.0, **kw, dtype=DTYPES[dt][1], device="cpu"))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("tag", [TC.FORWARD, TC.INVERSE])
def test_projection_and_distortion(tag, dt):
    npd, _, atol = DTYPES[dt]
    ref_model, model = _camera_pair(tag, dt)
    rng = np.random.default_rng(2)
    px = rng.uniform([0, 0], [320, 240], size=(64, 2)).astype(npd)
    rays = jax.vmap(lambda p: JD.image_to_3d(p, ref_model))(jnp.asarray(px))
    got_rays = TD.image_to_3d(torch.from_numpy(px), model)
    _close(got_rays, rays, atol)
    back_ref = jax.vmap(lambda r: JD.image_from_3d(r, ref_model))(rays)
    back = TD.image_from_3d(torch.from_numpy(np.asarray(rays)), model)
    _close(back, back_ref, 400 * atol)  # pixels: the 400 px focal scales the ray tolerance

    xy = (px - 160.0) / 400.0
    rad, tan = np.asarray(ref_model.radial_distortion), np.asarray(ref_model.tangential_distortion)
    _close(TD.distort_projected_ray(torch.from_numpy(xy), torch.from_numpy(rad), torch.from_numpy(tan)),
           JD.distort_projected_ray(jnp.asarray(xy), jnp.asarray(rad), jnp.asarray(tan)), atol)
    und_ref = jax.vmap(lambda t: JD.undistort_iterative(t, jnp.asarray(rad), jnp.asarray(tan)))(jnp.asarray(xy))
    _close(TD.undistort_iterative(torch.from_numpy(xy), torch.from_numpy(rad), torch.from_numpy(tan)),
           und_ref, atol)
    pts = np.concatenate([xy, np.full((64, 1), 2.0, npd)], axis=1)
    _close(TD.project_planar(torch.from_numpy(pts)), JD.project_planar(jnp.asarray(pts)), atol)

    q = _unit_quats(rng, 1, npd)[0]
    pos = np.asarray([3.0, -2.0, 50.0], npd)
    d_ref, o_ref = jax.vmap(lambda p: JD.image_to_3d_world(p, ref_model, jnp.asarray(pos), jnp.asarray(q)))(jnp.asarray(px))
    d, o = TD.image_to_3d_world(torch.from_numpy(px), model, torch.from_numpy(pos), torch.from_numpy(q))
    _close(d, d_ref, atol)
    _close(o, pos, 0)
    world = (pos + 40.0 * np.asarray(d_ref)).astype(npd)  # points seen inside the image
    p_ref = jax.vmap(lambda w: JD.image_from_3d_world(w, ref_model, jnp.asarray(pos), jnp.asarray(q)))(jnp.asarray(world))
    p = TD.image_from_3d_world(torch.from_numpy(world), model, torch.from_numpy(pos), torch.from_numpy(q))
    _close(p, p_ref, 400 * atol)


@pytest.mark.parametrize("dt", DTYPES)
def test_distort_keypoints_batched(dt):
    npd, _, atol = DTYPES[dt]
    ref_model, model = _camera_pair(TC.FORWARD, dt)
    rng = np.random.default_rng(3)
    p1 = rng.uniform([0, 0], [320, 240], size=(3, 40, 2)).astype(npd)
    p2 = rng.uniform([0, 0], [320, 240], size=(3, 40, 2)).astype(npd)
    models = model.map(lambda x: x.expand((3,) + x.shape))
    r1, r2 = TD.distort_keypoints(torch.from_numpy(p1), torch.from_numpy(p2), models, models)
    for k in range(3):
        ref1, ref2 = JD.distort_keypoints(jnp.asarray(p1[k]), jnp.asarray(p2[k]), ref_model, ref_model)
        _close(r1[k], ref1, atol)
        _close(r2[k], ref2, atol)


def _plane_homography(rng, dtype):
    """A calibrated plane-induced homography H = R + t n^T / d, its 4-point
    samples and scored correspondences."""
    axis = rng.normal(size=3)
    R = np.asarray(JQ.quat_to_matrix(JQ.quat_from_axis_angle(axis, 0.2)))
    t = np.asarray([0.3, -0.1, 0.05])
    n = np.asarray([0.05, -0.02, 1.0]) / np.linalg.norm([0.05, -0.02, 1.0])
    H = R + np.outer(t, n) / 2.0
    x1 = rng.uniform(-0.4, 0.4, size=(50, 2))
    h = np.concatenate([x1, np.ones((50, 1))], 1) @ H.T
    x2 = h[:, :2] / h[:, 2:] + rng.normal(scale=1e-3, size=(50, 2))
    return H.astype(dtype), x1.astype(dtype), x2.astype(dtype)


@pytest.mark.parametrize("dt", DTYPES)
def test_homography_fit_error_and_degeneracy(dt):
    npd, _, atol = DTYPES[dt]
    rng = np.random.default_rng(4)
    H, x1, x2 = _plane_homography(rng, npd)
    s = rng.integers(0, 50, size=(16, 4))
    sp1, sp2 = x1[s], x2[s]
    sp1[3, 2] = sp1[3, 0]  # a degenerate sample
    T, J = torch.from_numpy, jnp.asarray  # noqa: N806
    rays = np.concatenate([x1, np.ones((50, 1), npd)], 1)
    _close(TM.hnormalize(T(rays * 3)), JM.hnormalize(J(rays * 3)), atol)
    _close(TM.inv3(T(H)), JM.inv3(J(H)), atol)
    _close(TM._canonical_transform(T(sp1)), jax.vmap(JM._canonical_transform)(J(sp1)), 10 * atol)
    _close(TM._homography_rows(T(x1), T(x2)), JM._homography_rows(J(x1), J(x2)), atol)
    hyps_ref = jax.vmap(JM.homography_fit)(J(sp1), J(sp2))
    hyps = TM.homography_fit(T(sp1), T(sp2))
    fin = np.isfinite(np.asarray(hyps_ref)).all(axis=(1, 2)) & (np.abs(np.asarray(hyps_ref)).max(axis=(1, 2)) < 1e3)
    _close(hyps[fin], np.asarray(hyps_ref)[fin], 100 * atol)
    np.testing.assert_array_equal(TM.homography_sample_degenerate(T(sp1)).numpy(),
                                  np.asarray(jax.vmap(JM.homography_sample_degenerate)(J(sp1))))
    w = (rng.random(50) < 0.8).astype(npd)
    Hw_ref = JM.homography_fit_weighted(J(x1), J(x2), J(w))
    _close(TM.homography_fit_weighted(T(x1), T(x2), T(w)), Hw_ref, 10 * atol)
    _close(TM.homography_error(T(H), T(x1), T(x2)), JM.homography_error(J(H), J(x1), J(x2)), atol)


@pytest.mark.parametrize("dt", DTYPES)
def test_homography_decompose_and_pose_scores(dt):
    npd, _, atol = DTYPES[dt]
    rng = np.random.default_rng(5)
    H, x1, x2 = _plane_homography(rng, npd)
    R_ref, t_ref, n_ref, valid_ref = (np.asarray(a) for a in JM.homography_decompose(jnp.asarray(H)))
    R, t, n, valid = (a.numpy() for a in TM.homography_decompose(torch.from_numpy(H)))
    np.testing.assert_array_equal(valid, valid_ref)
    # as a set: each reference candidate has a port candidate with the same
    # R, and (t, n) equal up to a joint sign
    for k in range(4):
        errs = [
            max(np.abs(R[m] - R_ref[k]).max(),
                min(max(np.abs(s * t[m] - t_ref[k]).max(), np.abs(s * n[m] - n_ref[k]).max())
                    for s in (1.0, -1.0)))
            for m in range(4)
        ]
        assert min(errs) < 10 * atol, errs
    # scores and quaternions from the same candidates
    rays1 = np.concatenate([x1, np.ones((50, 1), npd)], 1)
    rays2 = np.concatenate([x2, np.ones((50, 1), npd)], 1)
    w = np.ones(50, npd)
    T, J = torch.from_numpy, jnp.asarray  # noqa: N806
    _close(TM.score_homography_poses(T(R_ref), T(t_ref), T(n_ref), T(rays1), T(rays2), T(w)),
           JM.score_homography_poses(J(R_ref), J(t_ref), J(n_ref), J(rays1), J(rays2), J(w)), 0)
    _close(TM.poses_to_quaternions(T(R_ref)), JM.poses_to_quaternions(J(R_ref)), atol)
    # a non-finite H yields invalid NaN candidates on both
    bad = H.copy()
    bad[0, 0] = np.nan
    assert not TM.homography_decompose(torch.from_numpy(bad))[3].any()
    assert not np.asarray(JM.homography_decompose(jnp.asarray(bad))[3]).any()


def test_interop_camera_round_trip():
    ref, _ = _camera_pair(TC.INVERSE, "float64")
    model = interop.camera_from(ref, "cpu")
    assert model.tag == TC.INVERSE
    back = JC.CameraModel(**interop.camera_to_numpy(model))
    for k in TC.LEAVES:
        assert getattr(model, k).shape == np.shape(getattr(ref, k))
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), np.asarray(getattr(ref, k)))
    assert back.tag == ref.tag
