"""The port's group solvers over several devices (``solve_group_batch`` and
``solve_group_batch_shared`` with ``devices``, ``parallel/mesh.py``,
``parallel/dryrun.py``, ``RelaxStage(devices=...)``) against the JAX
package's, in float64 on the CPU, Cholesky route.

The port's shards are ``"cpu"`` listed D times; the JAX side runs on
``jax.devices()[:D]`` of the 8-device virtual CPU mesh of tests/conftest.py.
The problems are the JAX package's synthetic bundle-adjustment groups
(``sharded_ba.make_synthetic_groups`` as tests/test_group_solver.py wraps
them, in float64), stacked by the JAX package and carried across by
``interop``, with the 3-d points freed for the surface pre-solve.

Tolerances. Independent lanes: against the JAX package on the same device
count per lane within 1e-9 relative (each leaf's largest difference in a
lane against its largest magnitude there, plus 1e-12) with equal iterations;
against the port's own one-device solve bit for bit (a lane's operations do
not depend on the other lanes of its shard). Joint solve: against the JAX
package on the same device count within 1e-6 relative (the shared solver's
bound, PERF.md §2), the focal equal across groups; against the port's own
one-shard solve within 1e-9 (D shards sum the reduced systems in another
order). The point problems' pre-solve, one lane-batched LM, against the
groups solved one after another by ``lm.solve`` within 1e-9. A relax stage
on two shards against the one-device stage within 1e-9.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.parallel import group_solver as JGS
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import dryrun as TDR
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.parallel.mesh import GroupMesh, shard_devices
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.relax import lm as TLM
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.relax.tangent import FIELDS
from opencalibration_tpu_torch.types import graph as TG
from tests.test_torch_ground_mesh import _grid_mesh, _tracked_graph
from tests.test_torch_shared_solver import _points_builts
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LANE_REL, LANE_ABS = 1e-9, 1e-12
SHARED_REL = 1e-6
OWN_REL = 1e-9
ITERS = 15
STAGE_ITERS = 6  # LM iterations of each relax-stage solve


@functools.lru_cache(maxsize=None)
def _reference_builts(G):
    return _points_builts(G)[0]


def _batch(G, shared, pre_solve=True):
    """(JAX batch, port batch) of G synthetic point-problem groups; the
    surface pre-solve frees the points."""
    j_builts = copy.deepcopy(_reference_builts(G))  # a shared batch rewrites its builts
    j_batch = JGS.build_group_batch(j_builts, shared_intrinsics=shared)
    lay = j_batch.layout
    if pre_solve:
        sf = np.zeros_like(np.asarray(j_batch.free))
        sf[:, lay.point_off:lay.focal_off] = np.asarray(j_batch.free)[:, lay.point_off:lay.focal_off]
        j_batch = dataclasses.replace(j_batch, surface_free=jnp.asarray(sf))
    return j_batch, interop.group_batch_from(j_batch, "cpu")


def _assert_lanes_close(got, want, G, rel, iterations=True):
    """Per lane: each leaf within ``rel`` of the lane's largest magnitude of
    that leaf; equal iterations when asked."""
    (g_solved, g_info), (w_solved, w_info) = got, want
    if iterations:
        np.testing.assert_array_equal(np.ravel(np.asarray(g_info.iterations))[:G],
                                      np.ravel(np.asarray(w_info.iterations))[:G])
    for f in FIELDS:
        a, b = np.asarray(getattr(g_solved, f))[:G], np.asarray(getattr(w_solved, f))[:G]
        for g in range(G):
            scale = np.max(np.abs(b[g]), initial=0.0)
            diff = np.max(np.abs(a[g] - b[g]), initial=0.0)
            assert diff <= rel * scale + LANE_ABS, f"lane {g} {f}: {diff} against {scale}"


# ---------------------------------------------------------------------------
# Independent lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G,D", [(3, 2), (5, 4)])
def test_solve_group_batch_over_shards_matches_reference(G, D):
    j_batch, t_batch = _batch(G, shared=False)
    assert TLM.route(t_batch.layout.dim) == "cholesky"
    own_batch = copy.deepcopy(t_batch)
    want = JGS.solve_group_batch(j_batch, True, max_iterations=ITERS, devices=jax.devices()[:D])
    got = TGS.solve_group_batch(t_batch, True, max_iterations=ITERS, devices=["cpu"] * D)
    assert got[1].iterations.shape == (G,) and (got[1].iterations > 1).all()
    _assert_lanes_close(got, want, G, LANE_REL)
    for k in ("initial_cost", "final_cost", "final_lambda"):
        np.testing.assert_allclose(getattr(got[1], k).numpy(), np.asarray(getattr(want[1], k)), rtol=LANE_REL,
                                   atol=LANE_ABS, err_msg=k)
    # the port on one device: every lane bit for bit, equal iterations
    one, one_info = TGS.solve_group_batch(own_batch, True, max_iterations=ITERS)
    np.testing.assert_array_equal(got[1].iterations.numpy(), one_info.iterations.numpy())
    for f in FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(one, f)), f
    assert torch.equal(t_batch.warm_lambda[0], own_batch.warm_lambda[0])


# ---------------------------------------------------------------------------
# The joint solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared_runs():
    """The three-group joint solve (no pre-solve) of each package on 1 and on
    3 devices: {D: (port out, JAX out, port batch)}."""
    out = {}
    for D in (1, 3):
        j_batch, t_batch = _batch(3, shared=True, pre_solve=False)
        want = JGS.solve_group_batch_shared(j_batch, False, max_iterations=ITERS, devices=jax.devices()[:D])
        got = TGS.solve_group_batch_shared(t_batch, False, max_iterations=ITERS, devices=["cpu"] * D)
        out[D] = (got, (JGS.fetch_solved(want[0]), want[1]), t_batch)
    return out


@pytest.mark.parametrize("D", [1, 3])
def test_solve_group_batch_shared_over_shards_matches_reference(shared_runs, D):
    got, want, t_batch = shared_runs[D]
    (solved, info), (j_solved, j_info) = got, want
    assert int(info.iterations) == int(np.asarray(j_info.iterations)) >= 3
    _assert_lanes_close(got, want, 3, SHARED_REL, iterations=False)
    np.testing.assert_allclose(float(info.final_cost), float(np.asarray(j_info.final_cost)), rtol=SHARED_REL)
    for g in range(1, 3):
        assert torch.equal(solved.focal[g], solved.focal[0])
    assert abs(float(solved.focal[0, 0]) - 600.0) < 1.0  # the truth; the start is 612
    assert t_batch.warm_lambda[0].shape == (3,)


def test_solve_group_batch_shared_on_three_shards_matches_one(shared_runs):
    (one, one_info), _, one_batch = shared_runs[1]
    (three, three_info), _, three_batch = shared_runs[3]
    assert int(one_info.iterations) == int(three_info.iterations)
    _assert_lanes_close((three, three_info), (one, one_info), 3, OWN_REL, iterations=False)
    np.testing.assert_allclose(three_batch.warm_lambda[0].numpy(), one_batch.warm_lambda[0].numpy(), rtol=OWN_REL)


def test_shared_solve_pads_the_shards_with_weightless_copies():
    """Three groups on two shards: padded by one frozen, weightless copy of
    group 0 to two groups a shard; equal to the one-shard solve within 1e-9,
    and the warm damping kept for the three real groups only."""
    _, t_batch = _batch(3, shared=True, pre_solve=False)
    one_batch = copy.deepcopy(t_batch)
    two, two_info = TGS.solve_group_batch_shared(t_batch, False, max_iterations=ITERS, devices=["cpu", "cpu"])
    one, one_info = TGS.solve_group_batch_shared(one_batch, False, max_iterations=ITERS)
    assert two.quats.shape[0] == 3 and t_batch.warm_lambda[0].shape == (3,)
    assert int(two_info.iterations) == int(one_info.iterations)
    np.testing.assert_allclose(float(two_info.final_cost), float(one_info.final_cost), rtol=OWN_REL)
    _assert_lanes_close((two, two_info), (one, one_info), 3, OWN_REL, iterations=False)


def test_points_pre_solve_is_one_batched_solve_and_matches_serial():
    """The point problems' surface pre-solve runs the groups as lanes of one
    LM (on two shards here) and equals the groups solved one after another
    by ``lm.solve``, then the same joint solve, within 1e-9."""
    _, t_batch = _batch(3, shared=True, pre_solve=True)
    serial_batch = copy.deepcopy(t_batch)
    got, got_info = TGS.solve_group_batch_shared(t_batch, True, max_iterations=ITERS, devices=["cpu", "cpu"])
    # the serial route: each group alone, with the joint solve's down-weighting (none: no instance is all-shared)
    lay = serial_batch.layout
    pre = []
    for g in range(3):
        p, info = TLM.solve(TGS._group(serial_batch.params, g), [TGS._group(b, g) for b in serial_batch.blocks], lay,
                            serial_batch.surface_free[g], max_iterations=ITERS)
        assert int(info.iterations) > 1
        pre.append(p)
    serial_batch.params = TGS._stack_params(pre)
    want, want_info = TGS.solve_group_batch_shared(serial_batch, False, max_iterations=ITERS)
    assert int(got_info.iterations) == int(want_info.iterations)
    _assert_lanes_close((got, got_info), (want, want_info), 3, OWN_REL, iterations=False)


# ---------------------------------------------------------------------------
# The mesh, the entry points and the stage
# ---------------------------------------------------------------------------


def test_shards_on_one_device_never_alias():
    mesh = GroupMesh(["cpu", "cpu"])
    x = torch.arange(8.0).reshape(4, 2)
    parts = mesh.split(x)
    parts[0].add_(100.0)
    assert torch.equal(x, torch.arange(8.0).reshape(4, 2)) and torch.equal(parts[1], x[2:])
    for reduce, want in ((mesh.psum, x[:2] + x[2:]), (mesh.pmax, x[2:])):
        out = reduce([x[:2].clone(), x[2:].clone()])
        assert len(out) == 2 and all(torch.equal(o, want) for o in out)
        assert out[0].data_ptr() != out[1].data_ptr()
        out[1].mul_(-1.0)  # an in-place update on shard 1 ...
        assert torch.equal(out[0], want)  # ... does not reach shard 0
    flags = mesh.any([torch.tensor([True, False]), torch.tensor([False, False])])
    flags[0][1] = True
    assert flags[1].tolist() == [True, False]
    gathered = mesh.gather(mesh.split(x))
    gathered.zero_()
    assert x.sum() == 28.0
    assert mesh.shard_sizes(5) == [3, 2] and GroupMesh(["cpu"] * 4).shard_sizes(8) == [2, 2, 2, 2]
    assert shard_devices("cpu") == [torch.device("cpu")]
    assert shard_devices("cpu", ["cpu", "cpu"]) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("D", [2, 4])
def test_dryrun_multidevice(D):
    TDR.dryrun_multidevice(["cpu"] * D)


def test_tiny_built_problems_share_the_mesh_tail_and_match_one_shard():
    """The dry run's shared mesh problems (the surface pre-solve and the full
    solve over [mesh heights | intrinsics]) on two shards equal one shard
    within 1e-9; every group's copy of the shared tail is equal."""
    out = []
    for devices in (["cpu"], ["cpu", "cpu"]):
        builts = [TDR.make_tiny_built_problem(g, dtype=torch.float64, device="cpu") for g in range(2)]
        batch = TGS.build_group_batch(builts, shared_intrinsics=True)
        out.append(TGS.solve_group_batch_shared(batch, True, max_iterations=8, devices=devices))
    (one, one_info), (two, two_info) = out
    assert int(one_info.iterations) == int(two_info.iterations) >= 1
    for f in ("mesh_z", "focal", "radial"):
        assert torch.equal(getattr(two, f)[0], getattr(two, f)[1]), f
    _assert_lanes_close((two, two_info), (one, one_info), 2, OWN_REL, iterations=False)


def test_entry_matches_reference():
    import __graft_entry__ as JE

    j_fn, j_args = JE.entry()
    want = [np.asarray(x) for x in jax.jit(j_fn)(*j_args)]
    fn, args = TDR.entry("cpu")
    got = [x.numpy() for x in fn(*args)]
    assert [g.shape for g in got] == [w.shape for w in want]
    # float32 at lam 1e-4: the undamped focal step is ill-conditioned (see
    # tests/test_torch_sharded_ba.py), the poses and points are not
    for name, g, w in zip(("quats", "points", "focal"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3 if name == "focal" else 1e-5, atol=2e-4, err_msg=name)


def test_relax_stage_on_two_shards_matches_one_device(monkeypatch):
    """One relax pass of two pose groups (groups of 3 over the 2 x 3 survey
    of tests/test_torch_ground_mesh.py, ground mesh on) by a stage on the CPU
    and by a stage whose solves run on two CPU shards: the solver gets the
    shards, and the poses agree within 1e-9."""
    j_graph, ids, j_models = _tracked_graph()
    rng = np.random.default_rng(7)
    monkeypatch.setattr(ST, "POSE_GROUP_SIZE", 3)
    seen = []
    orig = ST.solve_group_batch

    def spy(batch, pre_solve, *args, **kw):
        seen.append(kw.get("devices"))
        return orig(batch, pre_solve, *args, **kw)

    monkeypatch.setattr(ST, "solve_group_batch", spy)
    poses = []
    mesh = _grid_mesh(rng, z_scale=0.8)
    for devices in (None, ["cpu", "cpu"]):
        graph = interop.graph_from(j_graph)
        gps = {nid: np.asarray(graph.get_node(nid).payload.position, np.float64) for nid in ids}
        stage = ST.RelaxStage(device="cpu", dtype=torch.float64, devices=devices)
        stage.max_lm_iterations = STAGE_ITERS
        stage.init(graph, [], gps, interop.model_store_from(j_models), relax_all=True, disable_parallelism=False,
                   options=RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1))
        assert len(stage._groups) == 2
        stage.run_all(graph, [TG.SurfaceModel(cloud=[], mesh=interop.mesh_from(mesh))])
        poses.append({p.node_id: np.asarray(p.orientation) for g in stage._groups for p in g.poses})
    assert seen[0] is None and seen[1] == [torch.device("cpu")] * 2
    one, two = poses
    assert one.keys() == two.keys()
    for nid in one:
        np.testing.assert_allclose(two[nid], one[nid], rtol=0, atol=OWN_REL)
    assert any(not np.allclose(one[nid], np.asarray(j_graph.get_node(nid).payload.orientation)) for nid in one)
