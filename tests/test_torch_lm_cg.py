"""Parity of the port's matrix-free CG path of the LM (the per-instance
operators, the block-Jacobi preconditioner, the PCG loop, the CG solve and
the group solver's route choice) with the JAX package, in float64.

Tolerances: the matrix-free operators equal the port's own one-hot dense
assembly within 1e-12 of the largest entry; operators, preconditioner
applies and the PCG step equal the JAX ones within 1e-9; CG solves equal the
JAX CG solve within 1e-6 with equal LM iteration counts; frozen slots do not
move at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.parallel import group_solver as JGS
from opencalibration_tpu.relax import blocks as JB
from opencalibration_tpu.relax import lm as JLM
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax import tangent as JT
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import lm as TLM
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax import tangent as TT
from tests.test_lm_cg import _mesh_problem
from tests.test_relax import ori_errors
from tests.test_torch_kernels_gpu import _mesh_relax_problem
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
DOWN = np.asarray([0.0, 1.0, 0.0, 0.0])


def _port_block(jb):
    """A JAX ``BlockSpec`` as the port's, with the port's residual function."""
    if jb.name == "plane_ray":
        fn = TB._plane_ray_resid_fixed if "fixed_dir" in jb.data else TB._plane_ray_resid_intrinsics
    else:
        fn = getattr(TB, jb.resid_one.__name__)
    return TB.BlockSpec(
        slots=interop.to_torch(jb.slots, "cpu", torch.int64), data=interop.block_data_from(jb.data, "cpu"),
        weight=interop.to_torch(jb.weight, "cpu"), resid_one=fn, num_residuals=jb.num_residuals,
        huber_delta=jb.huber_delta, name=jb.name,
    )


@pytest.fixture(scope="module")
def fixture():
    """The ground-plane mesh fixture of tests/test_lm_cg.py on both sides:
    (ground truth, (JAX params, blocks, layout, free, surface-only free),
    (the port's))."""
    truth, params, blocks, layout, free, surf = _mesh_problem()
    tl = TT.TangentLayout(layout.C, layout.V, layout.P, layout.M)
    port = (interop.relax_params_from(params, "cpu"), tuple(_port_block(b) for b in blocks), tl,
            torch.as_tensor(np.asarray(free)), torch.as_tensor(np.asarray(surf)))
    return np.asarray(truth), (params, blocks, layout, jnp.asarray(free), jnp.asarray(surf)), port


def _port_problems(fixture):
    """The CG fixture, and a refined 3 x 3 vertex mesh with the mesh priors
    (whose anchor instances repeat one slot)."""
    p, b, layout, free, _ = fixture[2]
    return [(p, b, layout, free), _mesh_relax_problem("cpu", dtype=F64)]


@pytest.mark.parametrize("which", [0, 1], ids=["plane", "mesh_priors"])
def test_matrix_free_operators_equal_dense_assembly(fixture, which):
    params, blocks, layout, free = _port_problems(fixture)[which]
    H, g = TLM.normal_equations(params, blocks, layout, free)
    quads = TLM._quads_all(params, blocks, free)
    order = TLM._flat_slot_order(blocks, layout.dim)
    tol = 1e-12 * float(H.abs().max())
    np.testing.assert_allclose(TLM._gn_grad(quads, blocks, order).numpy(), g.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(TLM._gn_diag(quads, blocks, order).numpy(), torch.diagonal(H).numpy(),
                               rtol=0, atol=tol)
    rng = np.random.default_rng(0)
    for _ in range(3):
        v = torch.as_tensor(rng.normal(size=layout.dim))
        np.testing.assert_allclose(TLM._gn_matvec(v, quads, blocks, order).numpy(), (H @ v).numpy(),
                                   rtol=0, atol=tol * float(v.abs().max()) * layout.dim)


def _jax_pieces(jax_problem, lam):
    params, blocks, layout, free, _ = jax_problem
    T = layout.dim
    quads = JLM._quads_all(params, blocks, free)
    perm, sorted_ids = JLM._flat_slot_order(blocks, T)
    g = JLM._gn_grad(quads, blocks, perm, sorted_ids, T)
    diag = jnp.clip(JLM._gn_diag(quads, blocks, perm, sorted_ids, T), 1e-10, 1e32)
    damp = lam * diag + (~free).astype(g.dtype)
    return quads, (perm, sorted_ids, T), g, diag, damp


def _port_pieces(port_problem, lam):
    params, blocks, layout, free, _ = port_problem
    quads = TLM._quads_all(params, blocks, free)
    order = TLM._flat_slot_order(blocks, layout.dim)
    g = TLM._gn_grad(quads, blocks, order)
    diag = torch.clamp(TLM._gn_diag(quads, blocks, order), 1e-10, 1e32)
    damp = lam * diag + (~free).to(g.dtype)
    return quads, order, g, diag, damp


def test_operators_and_preconditioners_match_jax(fixture):
    lam = 1e-3
    jq, jo, jg, jdiag, jdamp = _jax_pieces(fixture[1], lam)
    tq, to, tg, tdiag, tdamp = _port_pieces(fixture[2], lam)
    jblocks, jlayout = fixture[1][1], fixture[1][2]
    tblocks, tlayout = fixture[2][1], fixture[2][2]
    for got, ref in ((tg, jg), (tdiag, jdiag), (tdamp, jdamp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    j_bj = JLM._bj_build(jq, jblocks, jlayout, jdamp, jdiag)
    t_bj = TLM._bj_build(tq, tlayout, tdamp, tdiag, TLM._bj_segment_order(tblocks, tlayout))
    rng = np.random.default_rng(1)
    for _ in range(3):
        v = rng.normal(size=jlayout.dim)
        np.testing.assert_allclose(TLM._gn_matvec(torch.as_tensor(v), tq, tblocks, to).numpy(),
                                   np.asarray(JLM._gn_matvec(jnp.asarray(v), jq, jblocks, *jo)), rtol=0, atol=1e-9)
        np.testing.assert_allclose(t_bj(torch.as_tensor(v)).numpy(), np.asarray(j_bj(jnp.asarray(v))),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("precond", ["jacobi", "block"])
def test_pcg_matches_jax_and_its_stop_test(fixture, precond, monkeypatch):
    """One damped PCG step: the port's loop (stop test on the device, the
    state frozen after the stop) equals the JAX while-loop, and reading the
    stop flag every iteration gives bit for bit the same answer."""
    lam = 1e-3
    jq, jo, jg, jdiag, jdamp = _jax_pieces(fixture[1], lam)
    tq, to, tg, tdiag, tdamp = _port_pieces(fixture[2], lam)
    jblocks, jlayout = fixture[1][1], fixture[1][2]
    tblocks, tlayout = fixture[2][1], fixture[2][2]
    if precond == "block":
        j_pre = JLM._bj_build(jq, jblocks, jlayout, jdamp, jdiag)
        t_pre = TLM._bj_build(tq, tlayout, tdamp, tdiag, TLM._bj_segment_order(tblocks, tlayout))
    else:
        j_pre = lambda r: r / (jdiag + jdamp)  # noqa: E731
        t_pre = lambda r: r / (tdiag + tdamp)  # noqa: E731

    def j_mv(v):
        return JLM._gn_matvec(v, jq, jblocks, *jo) + jdamp * v

    def t_mv(v):
        return TLM._gn_matvec(v, tq, tblocks, to) + tdamp * v

    for rtol in (TLM.CG_RTOL, 1e-9):  # the first stops early, the second runs to the cap
        jx, jr = JLM._pcg(j_mv, -jg, j_pre, rtol, TLM.CG_MAX_ITERS)
        tx, tr = TLM._pcg(t_mv, -tg, t_pre, rtol, TLM.CG_MAX_ITERS)
        scale = float(np.abs(np.asarray(jx)).max())
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-9 * scale)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-9 * float(np.abs(np.asarray(jg)).max()))
        monkeypatch.setattr(TLM, "_CG_CHECK_EVERY", 1)
        ex, er = TLM._pcg(t_mv, -tg, t_pre, rtol, TLM.CG_MAX_ITERS)
        monkeypatch.undo()
        assert torch.equal(ex, tx) and torch.equal(er, tr)


@pytest.mark.parametrize("precond", ["jacobi", "block"])
def test_cg_solve_matches_jax(fixture, precond):
    truth = fixture[0]
    jp, jb, jl, jfree, jsurf = fixture[1]
    tp, tb, tl, tfree, tsurf = fixture[2]
    kw = dict(linear_solver="cg", cg_precond=precond)
    jp1, _ = JLM.solve(jp, jb, jl, jsurf, **kw)
    tp1, _ = TLM.solve(tp, tb, tl, tsurf, **kw)
    ref, ref_info = JLM.solve(jp1, jb, jl, jfree, **kw)
    got, info = TLM.solve(tp1, tb, tl, tfree, **kw)
    assert int(info.iterations) == int(ref_info.iterations) > 0
    for f in ("quats", "mesh_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(info.final_lambda), float(ref_info.final_lambda), rtol=1e-6)
    # and it recovered the cameras and the plane, as the reference's own test asks
    assert ori_errors(got.quats.numpy(), truth).max() < 5e-3
    np.testing.assert_allclose(got.mesh_z.numpy(), -10.0, atol=0.8)


@pytest.mark.parametrize("linear_solver", ["cg", "cholesky"])
def test_frozen_slots_never_move(fixture, linear_solver):
    tp, tb, tl, _, tsurf = fixture[2]
    got, info = TLM.solve(tp, tb, tl, tsurf, linear_solver=linear_solver)
    assert int(info.iterations) > 0 and not torch.equal(got.mesh_z, tp.mesh_z)
    # unchanged up to the retraction's renormalisation, as in the reference's test
    np.testing.assert_allclose(got.quats.numpy(), tp.quats.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(got.positions, tp.positions)


def test_unknown_solver_or_preconditioner_raises(fixture):
    tp, tb, tl, tfree, _ = fixture[2]
    for kw in (dict(linear_solver="qr"), dict(linear_solver="cg", cg_precond="ilu")):
        with pytest.raises(ValueError):
            TLM.solve(tp, tb, tl, tfree, **kw)


# ---------------------------------------------------------------------------
# The route: the reference decides dense against matrix-free from the padded
# layout of the stage's whole batch, not from each group's own dimension
# ---------------------------------------------------------------------------


def _group_builts(C, V, M=1):
    """A JAX and a port ``BuiltProblem`` of C cameras and V mesh slots with
    small blocks: the downwards prior and the mesh anchor."""
    quats = np.tile(DOWN, (C, 1))
    pos = np.column_stack([np.arange(C) * 10.0, np.zeros(C), np.full(C, 60.0)])
    jl, tl = JT.TangentLayout(C, V, 0, M), TT.TangentLayout(C, V, 0, M)
    jp = JT.RelaxParams.create(quats, pos, mesh_z=np.zeros(V), focal=np.ones(M), dtype=np.float64)
    tp = TT.RelaxParams.create(torch.as_tensor(quats), torch.as_tensor(pos), mesh_z=torch.zeros(V, dtype=F64),
                               focal=torch.ones(M, dtype=F64), dtype=F64)
    j_blocks = [JB.downwards_prior_block(jl, np.arange(C, dtype=np.int32), np.ones(C)),
                JB.mesh_anchor_block(jl, np.arange(V, dtype=np.int32), np.zeros(V), np.ones(V))]
    t_blocks = [TB.downwards_prior_block(tl, torch.arange(C), torch.ones(C, dtype=F64)),
                TB.mesh_anchor_block(tl, torch.arange(V), torch.zeros(V, dtype=F64), torch.ones(V, dtype=F64))]
    common = dict(cam_index={}, model_index={}, mesh=None, inverse_models=True, track_points=np.zeros((0, 3)),
                  track_errors=np.zeros(0), num_opt=C, v_real=V)
    j_built = JPB.BuiltProblem(params=jp, layout=jl, blocks=j_blocks, free_mask=jl.build_free_mask(mesh_free=True),
                               surface_free_mask=jl.build_free_mask(mesh_free=True), **common)
    t_free = tl.build_free_mask(mesh_free=True, device="cpu")
    t_built = TPB.BuiltProblem(params=tp, layout=tl, blocks=t_blocks, free_mask=t_free,
                               surface_free_mask=t_free, **common)
    return j_built, t_built


@pytest.mark.parametrize("groups", [
    [(300, 32)],  # own dim 932, batch dim 1568: the reference takes CG
    [(200, 32)],  # batch dim 800: dense
    [(3, 1024)],  # cameras bucketed to 4: dim 1036
    [(100, 64), (150, 256)],  # batch dim exactly 1024
    [(5, 32), (40, 32, 2)],  # two camera models in one group: dense
], ids=["one_group_cg", "one_group_dense", "mesh_heavy", "two_groups_at_threshold", "two_models"])
def test_route_follows_the_reference_batch_layout(groups, monkeypatch):
    pairs = [_group_builts(*g) for g in groups]
    j_layout = JGS.build_group_batch([j for j, _ in pairs]).layout
    t_layout = TGS.batch_layout([t for _, t in pairs])
    assert (t_layout.C, t_layout.V, t_layout.P, t_layout.M) == (j_layout.C, j_layout.V, j_layout.P, j_layout.M)
    want = "cg" if j_layout.dim >= JLM.CG_DIM_THRESHOLD else "cholesky"

    routes = []

    def recording_solve(params, blocks, layout, free, **kw):
        routes.append(kw["linear_solver"])
        return params, TLM.SolveInfo(*(torch.zeros((), dtype=F64) for _ in range(4)))

    monkeypatch.setattr(TLM, "solve", recording_solve)
    TGS.solve_groups([t for _, t in pairs], pre_solve=True)
    assert routes == [want] * (2 * len(pairs))
