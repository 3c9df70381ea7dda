"""Parity of the port's relative-orientation relax (tangent layout, the
decomposed-rotation and downwards-prior blocks, the dense LM solve) with the
JAX package.

Tolerances: residuals and costs 1e-9 and normal equations 1e-6 in float64;
solved quaternions 1e-4 with equal iteration counts (the reference's own
serial and batched paths drift a few 1e-5 over 40 iterations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.relax import blocks as JB
from opencalibration_tpu.relax import lm as JL
from opencalibration_tpu.relax import tangent as JT
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import lm as TL
from opencalibration_tpu_torch.relax import tangent as TT
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DOWN = np.asarray([0.0, 1.0, 0.0, 0.0])


def _problem(seed=0, rows=2, cols=3):
    """Ground-truth cameras on a grid and per-edge 4-candidate relative poses
    as the link stage hands them over: slot 0 the noisy truth, the others
    wrong rotations with lower scores; one edge carries nothing valid."""
    rng = np.random.default_rng(seed)
    C = rows * cols
    pos = np.asarray([[30.0 + 12 * c, 30.0 + 12 * r, 60.0 + 25 * (r % 2)]
                      for r in range(rows) for c in range(cols)])
    quats = []
    for _ in range(C):
        tilt = np.asarray(JQ.quat_from_axis_angle(rng.normal(size=3), rng.uniform(0, 0.05)))
        yaw = np.asarray(JQ.quat_from_axis_angle(np.asarray([0.0, 0, 1]), rng.uniform(-0.15, 0.15)))
        quats.append(np.asarray(JQ.quat_multiply(tilt, JQ.quat_multiply(yaw, DOWN))))
    quats = np.stack(quats)
    pa, pb = [], []
    for i in range(C):
        d2 = np.sum((pos[:, :2] - pos[i, :2]) ** 2, axis=1)
        for j in np.argsort(d2)[1:4]:
            pa.append(min(i, j)), pb.append(max(i, j))
    edges = sorted(set(zip(pa, pb)))
    pa, pb = np.asarray([e[0] for e in edges]), np.asarray([e[1] for e in edges])
    P = len(pa)
    rel_q = np.zeros((P, 4, 4))
    rel_t = np.zeros((P, 4, 3))
    for k, (a, b) in enumerate(edges):
        true_q = np.asarray(JQ.quat_multiply(quats[b], JQ.quat_conjugate(quats[a])))
        tdir = (pos[b] - pos[a]) / np.linalg.norm(pos[b] - pos[a])
        true_t = np.asarray(JQ.quat_rotate_inverse(quats[a], tdir))
        for s in range(4):
            noise = 0.01 if s == 0 else 0.6
            rel_q[k, s] = np.asarray(JQ.quat_boxplus(true_q, rng.normal(scale=noise, size=3)))
            rel_t[k, s] = true_t + rng.normal(scale=noise, size=3)
    rel_scores = np.sort(rng.uniform(5, 200, size=(P, 4)), axis=1)[:, ::-1].copy()
    rel_scores[-1] = 0.0
    return pos, quats, pa, pb, rel_q, rel_t, rel_scores


def _blocks(prob, dtype):
    """(jax params, blocks, layout, free), (port params, blocks, layout, free)."""
    pos, _, pa, pb, rel_q, rel_t, rel_scores = prob
    C, P = len(pos), len(pa)
    valid4 = rel_scores > 0.25 * rel_scores[:, :1]
    init = np.tile(DOWN, (C, 1))
    jl = JT.TangentLayout(C, 0, 0, 1)
    j_params = JT.RelaxParams.create(jnp.asarray(init, dtype), jnp.asarray(pos, dtype), dtype=dtype)
    j_blocks = (
        JB.decomposed_rotation_block(jl, jnp.asarray(pa, jnp.int32), jnp.asarray(pb, jnp.int32),
                                     jnp.asarray(rel_q, dtype), jnp.asarray(rel_t, dtype),
                                     jnp.asarray(rel_scores, dtype), jnp.asarray(valid4), jnp.ones(P, dtype)),
        JB.downwards_prior_block(jl, jnp.arange(C, dtype=jnp.int32), jnp.ones(C, dtype)),
    )
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=tdt)  # noqa: E731
    tl = TT.TangentLayout(C, 0, 0, 1)
    t_params = TT.RelaxParams.create(T(init), T(pos), dtype=tdt)
    t_blocks = (
        TB.decomposed_rotation_block(tl, torch.as_tensor(pa), torch.as_tensor(pb), T(rel_q), T(rel_t),
                                     T(rel_scores), torch.as_tensor(valid4), torch.ones(P, dtype=tdt)),
        TB.downwards_prior_block(tl, torch.arange(C), torch.ones(C, dtype=tdt)),
    )
    return ((j_params, j_blocks, jl, jl.build_free_mask()),
            (t_params, t_blocks, tl, tl.build_free_mask(device="cpu")))


def _at(params_j, params_t, quats):
    """Both params moved to the given rotations."""
    return (params_j.__class__(**{**params_j.__dict__, "quats": jnp.asarray(quats, params_j.quats.dtype)}),
            TT.RelaxParams(**{**params_t.__dict__, "quats": torch.as_tensor(quats, dtype=params_t.quats.dtype)}))


@pytest.fixture(scope="module")
def prob():
    return _problem()


def test_tangent_layout_and_params():
    ref, got = JT.TangentLayout(5, 3, 2, 2), TT.TangentLayout(5, 3, 2, 2)
    assert ref.dim == got.dim and ref.focal_off == got.focal_off
    idx = np.asarray([0, 1])
    for name in ("rot_slots", "mesh_slot", "point_slots", "focal_slot", "principal_slots",
                 "radial_slots", "tangential_slots"):
        np.testing.assert_array_equal(getattr(got, name)(torch.as_tensor(idx)).numpy(), getattr(ref, name)(idx))
    for kw in (dict(), dict(rot_free=np.asarray([1, 0, 1, 1, 0], bool), mesh_free=True, focal_free=True,
                            radial_tiers=2), dict(points_free=True, principal_free=True, tangential_free=True,
                                                  radial_tiers=3)):
        np.testing.assert_array_equal(got.build_free_mask(**kw, device="cpu").numpy(), ref.build_free_mask(**kw))

    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    fields = dict(positions=rng.normal(size=(5, 3)), mesh_z=rng.normal(size=3), points=rng.normal(size=(2, 3)),
                  focal=np.asarray([400.0, 19990.0]), principal=rng.normal(size=(2, 2)),
                  radial=rng.normal(size=(2, 3)), tangential=rng.normal(size=(2, 2)))
    p_ref = JT.RelaxParams.create(q, **fields)
    p = TT.RelaxParams.create(torch.as_tensor(q), **{k: torch.as_tensor(v) for k, v in fields.items()})
    delta = rng.normal(size=ref.dim) * 0.1
    r_ref, r = ref.retract(p_ref, jnp.asarray(delta)), got.retract(p, torch.as_tensor(delta))
    for f in TT.FIELDS:
        np.testing.assert_allclose(getattr(r, f).numpy(), np.asarray(getattr(r_ref, f)), rtol=0, atol=1e-12)


def test_residuals_and_costs(prob):
    (pj, bj, _, _), (pt, bt, _, _) = _blocks(prob, jnp.float64)
    for params_j, params_t in ((pj, pt), _at(pj, pt, prob[1])):
        for blk_j, blk_t in zip(bj, bt):
            np.testing.assert_allclose(TL._block_values(params_t, blk_t).numpy(),
                                       np.asarray(JL._block_values(params_j, blk_j)), rtol=0, atol=1e-9)
        np.testing.assert_allclose(float(TL.total_cost(params_t, bt)), float(JL.total_cost(params_j, bj)),
                                   rtol=1e-9)
    s = np.asarray([0.0, 0.01, 0.03, 1.0])
    for delta in (None, 0.1):
        for a, b in zip(TL._huber_rho_and_weight(torch.as_tensor(s), delta),
                        JL._huber_rho_and_weight(jnp.asarray(s), delta)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def test_normal_equations(prob):
    (pj, bj, jl, fj), (pt, bt, tl, ft) = _blocks(prob, jnp.float64)
    for params_j, params_t in ((pj, pt), _at(pj, pt, prob[1])):
        H_ref, g_ref = JL.normal_equations(params_j, bj, jl, jnp.asarray(fj))
        H, g = TL.normal_equations(params_t, bt, tl, ft)
        np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=0, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-6)
    rng = np.random.default_rng(2)
    A = rng.normal(size=(8, 8))
    A = A @ A.T + np.diag(10.0 ** rng.uniform(-2, 4, 8))
    b = rng.normal(size=8)
    np.testing.assert_allclose(TL._jacobi_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
                               np.asarray(JL._jacobi_solve(jnp.asarray(A), jnp.asarray(b))), rtol=1e-9)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_solve(prob, dtype):
    (pj, bj, jl, fj), (pt, bt, tl, ft) = _blocks(prob, dtype)
    ref, info_ref = JL.solve(pj, bj, jl, jnp.asarray(fj), init_lambda=0.1, max_iterations=50)
    got, info = TL.solve(pt, bt, tl, ft, init_lambda=0.1, max_iterations=50)
    print(f"iterations: reference {int(info_ref.iterations)}, port {int(info.iterations)}")
    assert int(info.iterations) == int(info_ref.iterations)
    np.testing.assert_allclose(got.quats.numpy(), np.asarray(ref.quats), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(info.final_cost), float(info_ref.final_cost), rtol=1e-3)
    assert float(info.final_cost) < float(info.initial_cost)
    # and the solve recovered the cameras
    err = np.asarray(JQ.quat_angle(JQ.quat_multiply(got.quats.numpy().astype(np.float64),
                                                    JQ.quat_conjugate(prob[1]))))
    assert np.degrees(err).max() < 2.0


def test_interop_round_trips(prob):
    (pj, bj, _, _), _ = _blocks(prob, jnp.float64)
    params = interop.relax_params_from(pj, "cpu")
    back = JT.RelaxParams(**interop.relax_params_to_numpy(params))
    for f in TT.FIELDS:
        assert getattr(params, f).shape == getattr(pj, f).shape
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(pj, f)))
    data = interop.block_data_from(bj[0].data, "cpu")
    assert data["cam_i"].dtype == torch.int64 and data["rel_valid"].dtype == torch.bool
    for k, v in interop.block_data_to_numpy(data).items():
        np.testing.assert_array_equal(v, np.asarray(bj[0].data[k]))
