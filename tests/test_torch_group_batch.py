"""The port's batched group solve (``group_solver.solve_group_batch`` over
``lm.solve_batch``, one LM over a leading lane axis) against the JAX
package's, in float64 on the CPU.

The survey is the 2 x 3 PGM relief survey of tests/test_torch_mesh_refinement.py
(8 m of relief, 70 m wavelength). Both pipelines start from the port's
INITIAL_PROCESSING state (graph, surfaces, GPS index and camera models
carried into the JAX package by ``interop``), with ``POSE_GROUP_SIZE``
patched to 2 in both packages: every MESH_REFINEMENT pass relaxes three
pose groups, which the batch pads to four lanes (a frozen copy of group 0).
Both pipelines refine at grid level 0 only (``_MESH_MAX_GRID_LEVELS``), for
time.

Tolerances: the port's batched solve against the JAX one on its single-device
path (``devices=jax.devices()[:1]``) on the Cholesky route within 1e-9
relative per lane (each leaf's largest difference in a lane against its
largest magnitude there, plus 1e-12), with equal per-lane iteration counts,
from a cold damping; from the warm damping of a refreshed batch within 1e-7
(from dampings of 1e-7 to 1e-5 each step is nearly Gauss-Newton on the mesh
heights, and the lane that ended the cold solve at its budget moves its
heights by 1.1e-8 relative on the CPU). On the matrix-free CG route
(forced by lowering both packages' threshold) after one and after two LM
iterations within 1e-9 as well, but not at the pass's budget: the inexact
CG step (rtol 1e-2) carries last-bit differences on, so that at the budget
the JAX package's own vmapped and single-lane CG solves of one lane differ
by 2.7e-4 in their parameters, and the two packages' final costs by up to
12 % in a lane that ends there unconverged (on the CPU). The batched solve
against the serial ``solve_groups`` within 1e-4 (the reference's own floor
between its serial and batched paths, ROADMAP 3b); chunked lanes
(``OC_TPU_MAX_GROUPS_PER_DISPATCH=3``, rounded down to chunks of 2 lanes) against one chunk within 1e-12 with
equal iterations; the lanes against one ``lm.solve`` each within 1e-9 on the
CG route. The pipelines' MESH_REFINEMENT pass for pass within
1e-6 rad and 1e-6 m, with equal mesh topology, the JAX side on its default
(sharded) path; the port's serial route (``use_batched_solver=False``)
against its batched first pass within 1e-4.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from opencalibration_tpu.parallel import group_solver as JGS
from opencalibration_tpu.pipeline import stages as JST
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
from opencalibration_tpu.relax import lm as JLM
from opencalibration_tpu.surface import mesh as JMesh
from opencalibration_tpu.types import graph as JGraph
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.relax import lm as TLM
from opencalibration_tpu_torch.relax.tangent import FIELDS
from opencalibration_tpu_torch.testing import survey as TS
from tests.test_torch_mesh_refinement import PASS_M, PASS_RAD, RELIEF_M, RELIEF_WAVELENGTH_M, _angle
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP_SIZE = 2
MAX_GRID_LEVELS = 0
LANE_REL, LANE_ABS = 1e-9, 1e-12
WARM_REL = 1e-7
SERIAL_TOL = 1e-4
CHUNK_TOL = 1e-12


def _log_pass(p):
    mesh = p.surfaces[0].mesh
    return dict(state=p.get_state(), vertices=np.array(mesh.vertices), triangles=np.array(mesh.triangles),
                orientation={n.payload.path: np.asarray(n.payload.orientation, np.float64) for _, n in p.graph.nodes()})


def _drive_mesh_refinement(p, solver_module, name):
    """MESH_REFINEMENT pass by pass; every call of ``solver_module.<name>``
    is recorded with a deep copy of its batch as it entered the solve."""
    calls, log = [], []
    orig = getattr(solver_module, name)

    def recording(batch, pre_solve, *args, **kw):
        calls.append(dict(batch=copy.deepcopy(batch), pre_solve=pre_solve, kw=dict(kw), pass_index=len(log)))
        return orig(batch, pre_solve, *args, **kw)

    setattr(solver_module, name, recording)
    try:
        while p.get_state() == PipelineState.MESH_REFINEMENT:
            p.iterate_once()
            log.append(_log_pass(p))
            assert len(log) < 40
    finally:
        setattr(solver_module, name, orig)
    return log, calls


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """The port's pipeline after INITIAL_PROCESSING of the survey, at the
    entry of MESH_REFINEMENT, refining at grid level 0 only."""
    paths, _, _ = TS.write_survey(str(tmp_path_factory.mktemp("relief_survey")), 2, 3, relief_amplitude=RELIEF_M,
                                  relief_wavelength=RELIEF_WAVELENGTH_M, device="cpu")
    port = Pipeline(batch_size=3, device="cpu", dtype=torch.float64)
    port.add(paths)
    while port.get_state() == PipelineState.INITIAL_PROCESSING:
        port.iterate_once()
    port._MESH_MAX_GRID_LEVELS = MAX_GRID_LEVELS
    return port


@pytest.fixture(scope="module")
def runs(entry):
    """Both pipelines' MESH_REFINEMENT from the port's INITIAL_PROCESSING
    state with groups of 2: (reference log, its solve calls, port log, its
    solve calls)."""
    port = copy.deepcopy(entry)
    ref = JPipeline(batch_size=3)
    ref.graph = interop.graph_from(port.graph, JGraph)
    ref.surfaces = [interop.surface_from(s, JGraph, JMesh.TriMesh) for s in port.surfaces]
    ref.gps_positions = copy.deepcopy(port.gps_positions)
    ref.model_store = {mid: JCameraModel(**interop.camera_to_numpy(m)) for mid, m in port.model_store.items()}
    ref.reset_state(PipelineState.MESH_REFINEMENT)
    ref._MESH_MAX_GRID_LEVELS = MAX_GRID_LEVELS
    sizes = (JST.POSE_GROUP_SIZE, ST.POSE_GROUP_SIZE)
    JST.POSE_GROUP_SIZE = ST.POSE_GROUP_SIZE = GROUP_SIZE
    try:
        # the JAX stage imports its solver from the module at each dispatch
        ref_log, ref_calls = _drive_mesh_refinement(ref, JGS, "solve_group_batch")
        port_log, port_calls = _drive_mesh_refinement(port, ST, "solve_group_batch")
    finally:
        JST.POSE_GROUP_SIZE, ST.POSE_GROUP_SIZE = sizes
    return ref_log, ref_calls, port_log, port_calls


def _pair(runs, k):
    """The k-th solve's batches of both packages as they entered it, its
    pre-solve flag and LM budget."""
    _, ref_calls, _, port_calls = runs
    j, t = ref_calls[k], port_calls[k]
    assert j["pre_solve"] == t["pre_solve"] and j["kw"] == t["kw"]
    return copy.deepcopy(j["batch"]), copy.deepcopy(t["batch"]), t["pre_solve"], t["kw"]["max_iterations"]


def _assert_lanes_match(t_out, j_out, G, rel=LANE_REL, lambda_rel=LANE_REL):
    """Equal iterations; every leaf of every lane within ``rel`` of the
    lane's largest magnitude of that leaf."""
    (t_solved, t_info), (j_solved, j_info) = t_out, j_out
    np.testing.assert_array_equal(t_info.iterations.numpy(), np.asarray(j_info.iterations)[:G])
    leaves = [(f, getattr(t_solved, f).numpy(), np.asarray(getattr(j_solved, f))[:G], rel) for f in FIELDS]
    leaves += [(k, getattr(t_info, k).numpy(), np.asarray(getattr(j_info, k))[:G], rel)
               for k in ("initial_cost", "final_cost")]
    leaves.append(("final_lambda", t_info.final_lambda.numpy(), np.asarray(j_info.final_lambda)[:G], lambda_rel))
    for name, got, want, tol in leaves:
        for g in range(G):
            scale = np.max(np.abs(want[g]), initial=0.0)
            diff = np.max(np.abs(got[g] - want[g]), initial=0.0)
            assert diff <= tol * scale + LANE_ABS, f"lane {g} {name}: {diff} against {scale}"


def _solve_both(j_batch, t_batch, pre_solve, iters):
    j_out = JGS.solve_group_batch(j_batch, pre_solve, max_iterations=iters, devices=jax.devices()[:1])
    t_out = TGS.solve_group_batch(t_batch, pre_solve, max_iterations=iters)
    return j_out, t_out


@pytest.fixture(scope="module")
def cold(runs):
    """The port's batched solve of the first pass's batch: (JAX batch, port
    batch after the solve, pre-solve flag, LM budget, port result)."""
    j_batch, t_batch, pre_solve, iters = _pair(runs, 0)
    assert j_batch.warm_lambda is None and t_batch.warm_lambda is None
    return j_batch, t_batch, pre_solve, iters, TGS.solve_group_batch(t_batch, pre_solve, max_iterations=iters)


def test_every_pass_is_one_batched_solve_of_three_groups_in_four_lanes(runs):
    ref_log, ref_calls, port_log, port_calls = runs
    assert len(port_log) == len(ref_log) >= 2
    assert [c["pass_index"] for c in port_calls] == list(range(len(port_log)))
    assert {c["batch"].num_groups for c in port_calls} == {3}
    assert TGS._bucket(3, minimum=1) == 4


def test_mesh_refinement_matches_reference_pass_for_pass(runs):
    ref_log, _, port_log, _ = runs
    for i, (got, ref) in enumerate(zip(port_log, ref_log)):
        np.testing.assert_array_equal(got["triangles"], ref["triangles"], err_msg=f"pass {i}")
        assert got["orientation"].keys() == ref["orientation"].keys()
        ori = max(_angle(got["orientation"][k], ref["orientation"][k]) for k in ref["orientation"])
        dz = float(np.abs(got["vertices"] - ref["vertices"]).max())
        assert ori <= PASS_RAD and dz <= PASS_M, f"pass {i}: {ori} rad, {dz} m"


def test_solve_group_batch_matches_reference_per_lane_then_warm_on_a_refreshed_batch(cold):
    """The first pass's batch from a cold damping; then each package's batch
    refreshed (``refresh_group_batch``: the values stacked again, the final
    damping kept) and solved again from that damping."""
    j_batch, t_batch, pre_solve, iters, t_out = cold
    assert TLM.route(t_batch.layout.dim) == "cholesky"
    j_out = JGS.solve_group_batch(j_batch, pre_solve, max_iterations=iters, devices=jax.devices()[:1])
    _assert_lanes_match(t_out, j_out, t_batch.num_groups)
    assert (t_out[1].iterations > 1).all()
    np.testing.assert_allclose(t_batch.warm_lambda[0].numpy(), np.asarray(j_batch.warm_lambda[0]),
                               rtol=LANE_REL, atol=LANE_ABS)
    assert t_batch.warm_lambda[1] is None and j_batch.warm_lambda[1] is None
    j_warm, t_warm = JGS.refresh_group_batch(j_batch), TGS.refresh_group_batch(t_batch)
    assert t_warm.warm_lambda is t_batch.warm_lambda
    j_out, t_out = _solve_both(j_warm, t_warm, pre_solve, iters)
    _assert_lanes_match(t_out, j_out, 3, rel=WARM_REL, lambda_rel=WARM_REL)


def test_the_reference_batch_carried_across_solves_as_the_ports_own(runs, cold):
    """``interop.group_batch_from`` carries the JAX package's stacked batch
    (blocks with the port's residual functions); solved by the port it
    equals the port's own batch's solve, and the JAX solve's info carried
    across equals the port's."""
    _, t_batch, pre_solve, iters, t_out = cold
    j_batch = _pair(runs, 0)[0]  # as it entered the first solve (cold)
    carried = interop.group_batch_from(j_batch, "cpu")
    assert carried.builts == [] and [b.name for b in carried.blocks] == [b.name for b in t_batch.blocks]
    out = TGS.solve_group_batch(carried, pre_solve, max_iterations=iters)
    _assert_lanes_match(out, t_out, t_batch.num_groups)
    j_info = JGS.solve_group_batch(j_batch, pre_solve, max_iterations=iters, devices=jax.devices()[:1])[1]
    info = interop.solve_info_from(j_info, "cpu")
    assert info.iterations.shape == (3,) and interop.solve_info_to_numpy(info).keys() == {
        "initial_cost", "final_cost", "iterations", "final_lambda"}
    np.testing.assert_array_equal(info.iterations.numpy(), t_out[1].iterations.numpy())


def test_solve_group_batch_matches_reference_per_lane_on_the_cg_route(runs, monkeypatch):
    """The CG route, forced by lowering both packages' routing threshold
    below the batch's tangent dimension (the JAX program is traced again)."""
    j_batch, t_batch, pre_solve, _ = _pair(runs, 0)
    monkeypatch.setattr(JLM, "CG_DIM_THRESHOLD", 1)
    monkeypatch.setattr(TLM, "CG_DIM_THRESHOLD", 1)
    jax.clear_caches()
    try:
        assert TLM.route(t_batch.layout.dim) == "cg"
        for k in (1, 2):
            j_out, t_out = _solve_both(copy.deepcopy(j_batch), copy.deepcopy(t_batch), pre_solve, k)
            _assert_lanes_match(t_out, j_out, t_batch.num_groups)
    finally:
        jax.clear_caches()


def test_batched_matches_serial_solve_groups(cold):
    _, t_batch, pre_solve, iters, (solved, _) = cold
    solved = TGS.fetch_solved(solved)
    serial, infos = TGS.solve_groups(t_batch.builts, pre_solve, max_iterations=iters)
    for g, s in enumerate(serial):
        lane = TGS.extract_group_params(t_batch, solved, g)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(lane, f), getattr(s, f), rtol=0, atol=SERIAL_TOL, err_msg=f)


def test_chunked_lanes_equal_one_chunk(runs, cold, monkeypatch):
    _, t_batch, pre_solve, iters = _pair(runs, 0)
    whole, whole_info = cold[-1]
    monkeypatch.setenv(TGS.MAX_GROUPS_ENV, "3")  # rounded down to 2: lanes [0, 2) and [2, 4)
    chunked, chunked_info = TGS.solve_group_batch(t_batch, pre_solve, max_iterations=iters)
    np.testing.assert_array_equal(chunked_info.iterations.numpy(), whole_info.iterations.numpy())
    for f in FIELDS:
        np.testing.assert_allclose(getattr(chunked, f).numpy(), getattr(whole, f).numpy(), rtol=0,
                                   atol=CHUNK_TOL, err_msg=f)


def test_padded_lanes_stop_after_one_iteration_and_cg_lanes_match_single_solves(runs):
    """Four lanes (three groups and a frozen copy) on the CG route: the
    frozen lane takes one iteration and keeps its parameters; each group's
    lane equals ``lm.solve`` of that group alone."""
    _, t_batch, _, _ = _pair(runs, 0)
    padded = TGS.pad_lanes(t_batch, 4)
    assert padded.free.shape[0] == 4 and not padded.free[3].any()
    kw = dict(max_iterations=20, linear_solver="cg")
    solved, info = TLM.solve_batch(padded.params, padded.blocks, padded.layout, padded.free, **kw)
    assert int(info.iterations[3]) == 1
    for f in FIELDS:
        assert torch.equal(getattr(solved, f)[3], getattr(padded.params, f)[3]), f
    for g in range(3):
        one, one_info = TLM.solve(TGS._group(padded.params, g), [TGS._group(b, g) for b in padded.blocks],
                                  padded.layout, padded.free[g], **kw)
        assert int(one_info.iterations) == int(info.iterations[g])
        for f in FIELDS:
            np.testing.assert_allclose(getattr(solved, f)[g].numpy(), getattr(one, f).numpy(), rtol=LANE_REL,
                                       atol=LANE_ABS, err_msg=f"lane {g} {f}")


def test_several_devices_are_the_multi_device_path(runs, cold):
    """Several devices take the multi-device path: the three groups padded to
    four lanes and cut into two shards (here both on the CPU), each solved
    by the lane-batched LM, in lockstep; every lane equals the one-device
    solve's bit for bit, with equal iterations."""
    _, t_batch, pre_solve, iters = _pair(runs, 0)
    whole, whole_info = cold[-1]
    sharded, sharded_info = TGS.solve_group_batch(t_batch, pre_solve, max_iterations=iters, devices=["cpu", "cpu"])
    np.testing.assert_array_equal(sharded_info.iterations.numpy(), whole_info.iterations.numpy())
    for f in FIELDS:
        assert torch.equal(getattr(sharded, f), getattr(whole, f)), f


def test_serial_route_stays_available(entry, runs):
    """``use_batched_solver=False`` (the batched route is the default) solves
    the groups of a pass one after another with ``solve_groups``: the first
    MESH_REFINEMENT pass from the same entry state equals the batched pass
    within 1e-4 rad and 1e-4 m, with the same mesh."""
    assert ST.RelaxStage(device="cpu").use_batched_solver is True
    p = copy.deepcopy(entry)
    p._relax_stage.use_batched_solver = False
    calls = []
    orig = (ST.solve_groups, ST.solve_group_batch, ST.POSE_GROUP_SIZE)

    def serial(builts, *args, **kw):
        calls.append(len(builts))
        return orig[0](builts, *args, **kw)

    def batched(*args, **kw):
        raise AssertionError("the serial route took the batched solve")

    ST.solve_groups, ST.solve_group_batch, ST.POSE_GROUP_SIZE = serial, batched, GROUP_SIZE
    try:
        p.iterate_once()
    finally:
        ST.solve_groups, ST.solve_group_batch, ST.POSE_GROUP_SIZE = orig
    assert calls == [3]
    got, want = _log_pass(p), runs[2][0]
    np.testing.assert_array_equal(got["triangles"], want["triangles"])
    assert got["orientation"].keys() == want["orientation"].keys()
    ori = max(_angle(got["orientation"][k], want["orientation"][k]) for k in want["orientation"])
    dz = float(np.abs(got["vertices"] - want["vertices"]).max())
    assert ori <= SERIAL_TOL and dz <= SERIAL_TOL, f"{ori} rad, {dz} m"
