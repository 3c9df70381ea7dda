"""The port's group batch and shared-intrinsics joint solver
(opencalibration_tpu_torch/parallel/group_solver.py) against the JAX package's,
in float64 on the CPU.

Two problems are used. The mesh problem is the 2 x 3 relief survey of
tests/test_torch_ground_mesh.py split into two groups (one per image row)
with two camera models, built by each package's own ``build_mesh_problem``
with intrinsics free. The points problem is the JAX package's synthetic
bundle-adjustment groups (``sharded_ba.make_synthetic_groups``, as
tests/test_group_solver.py wraps them), carried across by ``interop``.

Tolerances: the stacked batch equal in slots, masks, integer data and the
rewritten ``model_index``; float leaves within 1e-12 (absolute plus relative)
except intrinsics leaves, which hold iteratively inverted models (1e-7, see
tests/test_torch_camera_relax.py). Joint solves: focal within 1e-6 relative,
quaternions, points and heights within 1e-6, equal iteration counts. Shared
against one dense joint solve: focal within 0.2 px, as the reference's own
test asks. The JAX solver runs on its 4 of 8 virtual CPU devices.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.parallel import group_solver as JGS
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax.tangent import TangentLayout as JLayout
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu.types.graph import SurfaceModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import lm as TLM
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.types import graph as TG
from tests.test_group_solver import _synthetic_builts
from tests.test_torch_camera_relax import BLOCK_TOL, CONVERSION_TOL, TIERS
from tests.test_torch_ground_mesh import _grid_mesh, _tracked_graph
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
SOLVE_REL = 1e-6
INTRINSICS = ("focal", "principal", "radial", "tangential")


# ---------------------------------------------------------------------------
# The two-group, two-model mesh problem
# ---------------------------------------------------------------------------


def _node_poses(graph, node_ids, types):
    return [types.NodePose(node_id=i, orientation=np.asarray(graph.get_node(i).payload.orientation).copy(),
                           position=np.asarray(graph.get_node(i).payload.position).copy()) for i in node_ids]


@pytest.fixture(scope="module")
def survey():
    """Graph, ids and model stores of the two-model survey, and the two
    groups as (node ids, model ids, edge ids). Group A is the first image row
    with every edge that touches it (the second row is its frozen boundary)
    and both models; group B is the second row with the edges inside it and
    model 2 alone, so its one local model slot maps to global slot 1."""
    graph, ids, j_models = _tracked_graph()
    j_models[2] = JCameraModel.create(395.0, (161.0, 119.0), (-0.05, 0.01, 0.0), (0.0, 0.0), 320, 240,
                                      dtype=jnp.float64)
    for nid in ids[3:]:
        graph.get_node(nid).payload.model_id = 2
    row_a, row_b = set(ids[:3]), set(ids[3:])
    edges_a = sorted(eid for eid, e in graph.edges() if e.source in row_a or e.dest in row_a)
    edges_b = sorted(eid for eid, e in graph.edges() if e.source in row_b and e.dest in row_b)
    assert edges_a and edges_b
    rng = np.random.default_rng(7)
    cloud = np.column_stack([rng.uniform(-10, 40, 50), rng.uniform(-10, 30, 50), rng.normal(size=50)])
    previous = [SurfaceModel(cloud=[cloud], mesh=_grid_mesh(rng, z_scale=0.8))]
    groups = [(ids[:3], (1, 2), edges_a), (ids[3:], (2,), edges_b)]
    return graph, ids, j_models, groups, previous


def _builts(survey, tier=0):
    """(JAX builts, port builts) of the two groups under option tier ``tier``."""
    graph, ids, j_models, groups, previous = survey
    t_graph = interop.graph_from(graph)
    t_models = interop.model_store_from(j_models)
    t_previous = [interop.surface_from(s) for s in previous]
    opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[tier])
    opts_t = interop.relax_options_from(opts_j)
    j_builts, t_builts = [], []
    for node_ids, mids, edge_ids in groups:
        j_builts.append(JPB.build_mesh_problem(graph, _node_poses(graph, node_ids, JG), {m: j_models[m] for m in mids},
                                               edge_ids, opts_j, previous, 0.1))
        t_builts.append(TPB.build_mesh_problem(t_graph, _node_poses(t_graph, node_ids, TG),
                                               {m: t_models[m] for m in mids}, edge_ids, opts_t, t_previous, 0.1,
                                               dtype=F64, device="cpu"))
    assert all(b is not None for b in j_builts + t_builts)
    return j_builts, t_builts


def _assert_same_batch(got: TGS.GroupBatch, ref):
    lay, rl = got.layout, ref.layout
    assert (lay.C, lay.V, lay.P, lay.M) == (rl.C, rl.V, rl.P, rl.M)
    assert got.num_groups == ref.num_groups and got.shared_intrinsics == ref.shared_intrinsics
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(ref.free))
    np.testing.assert_array_equal(got.surface_free.numpy(), np.asarray(ref.surface_free))
    for f in FIELDS:
        tol = CONVERSION_TOL if f in INTRINSICS else BLOCK_TOL
        np.testing.assert_allclose(getattr(got.params, f).numpy(), np.asarray(getattr(ref.params, f)), err_msg=f, **tol)
    assert [b.name for b in got.blocks] == [b.name for b in ref.blocks]
    for gb, rb in zip(got.blocks, ref.blocks):
        np.testing.assert_array_equal(gb.slots.numpy(), np.asarray(rb.slots), err_msg=rb.name)
        np.testing.assert_array_equal(gb.weight.numpy(), np.asarray(rb.weight), err_msg=rb.name)
        assert set(gb.data) == set(rb.data)
        for k, v in gb.data.items():
            want = np.asarray(rb.data[k])
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{rb.name}.{k}")
            else:
                np.testing.assert_allclose(v.numpy(), want, err_msg=f"{rb.name}.{k}", **BLOCK_TOL)
    for g, r in zip(got.model_perms, ref.model_perms):
        np.testing.assert_array_equal(g, r)


def test_build_group_batch_shared_matches_reference(survey):
    j_builts, t_builts = _builts(survey)
    local = [dict(b.model_index) for b in t_builts]
    assert local == [{1: 0, 2: 1}, {2: 0}]
    local_focal = [b.params.focal.clone() for b in t_builts]
    ref = JGS.build_group_batch(j_builts, shared_intrinsics=True)
    got = TGS.build_group_batch(t_builts, shared_intrinsics=True)
    _assert_same_batch(got, ref)
    assert got.layout.M == 2 and got.params.focal.shape == (2, 2)
    # one global model list: every group's intrinsics leaves are the same values
    for f in INTRINSICS:
        assert torch.equal(getattr(got.params, f)[0], getattr(got.params, f)[1])
    # group B's one model sits at global slot 1: its intrinsics slots and model_i moved there
    np.testing.assert_array_equal(got.model_perms[1], [1])
    plane = got.blocks[0]
    real = plane.weight[1] > 0
    assert (plane.data["model_i"][1][real] == 1).all()
    assert (plane.slots[1][real][:, 3] == got.layout.focal_off + 1).all()
    assert set(np.unique(plane.data["model_i"][0][plane.weight[0] > 0].numpy())) == {0, 1}
    # each built was rewritten IN PLACE to the global list, on both sides
    for tb, jb in zip(t_builts, j_builts):
        assert tb.model_index == jb.model_index
        assert tb.params.M == 2
        for f in INTRINSICS:
            np.testing.assert_allclose(getattr(tb.params, f).numpy(), np.asarray(getattr(jb.params, f)), **CONVERSION_TOL)
    assert t_builts[1].model_index == {2: 1}
    assert torch.equal(t_builts[1].params.focal[1], local_focal[1][0])
    assert torch.equal(t_builts[1].params.focal[0], local_focal[0][0])
    # group B's free mask frees the focal of its own model only, at the global slot
    fo = got.layout.focal_off
    assert got.free[0, fo : fo + 2].tolist() == [True, True] and got.free[1, fo : fo + 2].tolist() == [False, True]


def test_unshared_batch_matches_reference(survey):
    j_builts, t_builts = _builts(survey)
    ref = JGS.build_group_batch(j_builts)
    got = TGS.build_group_batch(t_builts)
    _assert_same_batch(got, ref)
    assert [b.model_index for b in t_builts] == [{1: 0, 2: 1}, {2: 0}]  # nothing rewritten
    lay = TGS.batch_layout(t_builts)
    assert (lay.C, lay.V, lay.P, lay.M) == (got.layout.C, got.layout.V, got.layout.P, got.layout.M)


def test_slot_and_mask_translation():
    """Moving slots and masks between layouts is a pure re-indexing, with and
    without a model permutation; equal to the reference's."""
    old, new = TangentLayout(2, 3, 1, 2), TangentLayout(4, 8, 2, 3)
    j_old, j_new = JLayout(2, 3, 1, 2), JLayout(4, 8, 2, 3)
    slots = np.arange(old.dim).reshape(1, -1)
    for perm in (None, np.asarray([2, 0])):
        got = TGS._translate_slots(torch.as_tensor(slots), old, new, perm)
        np.testing.assert_array_equal(got, JGS._translate_slots(slots, j_old, j_new, perm))
        assert len(np.unique(got)) == old.dim  # injective
        mask = np.zeros(old.dim, bool)
        mask[[old.mesh_off + 2, old.focal_off, old.radial_off + 3]] = True
        out = TGS._translate_mask(torch.as_tensor(mask), old, new, perm)
        np.testing.assert_array_equal(out, JGS._translate_mask(mask, j_old, j_new, perm))
        # a mask entry lands where its slot lands
        np.testing.assert_array_equal(np.flatnonzero(out), np.sort(got[0][mask]))
    assert TGS._translate_slots(np.asarray([old.focal_off + 1]), old, new, np.asarray([2, 0]))[0] == new.focal_off


def _solved_numpy(solved):
    return {f: np.asarray(getattr(solved, f)) for f in FIELDS}


def _assert_same_solution(got, ref, info_t, info_j):
    """Joint solves of the two packages: SOLVE_REL on everything that moved."""
    got, ref = _solved_numpy(TGS.fetch_solved(got)), _solved_numpy(ref)
    np.testing.assert_allclose(got["focal"], ref["focal"], rtol=SOLVE_REL, atol=0)
    for f in ("principal", "radial", "tangential", "mesh_z", "points"):
        np.testing.assert_allclose(got[f], ref[f], rtol=SOLVE_REL, atol=SOLVE_REL, err_msg=f)
    flip = np.sign(np.sum(got["quats"] * ref["quats"], axis=-1, keepdims=True))
    np.testing.assert_allclose(flip * got["quats"], ref["quats"], rtol=0, atol=SOLVE_REL)
    assert int(info_t.iterations) == int(np.ravel(np.asarray(info_j.iterations))[0])
    np.testing.assert_allclose(float(info_t.final_cost), float(np.ravel(np.asarray(info_j.final_cost))[0]),
                               rtol=1e-6)


@pytest.mark.parametrize("tier", [0, 3], ids=["focal", "radial3_principal"])
def test_shared_solve_of_the_mesh_problem_matches_reference(survey, tier):
    """Surface pre-solve and full solve of the two-group problem, the mesh
    heights and both camera models shared."""
    j_builts, t_builts = _builts(survey, tier)
    j_batch = JGS.build_group_batch(j_builts, shared_intrinsics=True)
    t_batch = TGS.build_group_batch(t_builts, shared_intrinsics=True)
    j_solved, j_info = JGS.solve_group_batch_shared(j_batch, pre_solve=True, max_iterations=30)
    t_solved, t_info = TGS.solve_group_batch_shared(t_batch, pre_solve=True, max_iterations=30)
    _assert_same_solution(t_solved, JGS.fetch_solved(j_solved), t_info, j_info)
    assert int(t_info.iterations) >= 3 and float(t_info.final_cost) < float(t_info.initial_cost)
    # every group's copy of the shared tail is the same, bit for bit
    for f in ("mesh_z",) + INTRINSICS:
        leaf = getattr(t_solved, f)
        assert torch.equal(leaf[0], leaf[1]), f
    assert not torch.equal(t_solved.focal[0], t_batch.params.focal[0])  # the focal moved
    # the exit dampings are kept for the next pass, as in the reference
    np.testing.assert_allclose(t_batch.warm_lambda[0].numpy(), np.asarray(j_batch.warm_lambda[0]), rtol=1e-6)
    np.testing.assert_allclose(float(t_batch.warm_lambda[1]), float(np.asarray(j_batch.warm_lambda[1])), rtol=1e-6)
    # group parameters come back at their own sizes with the global intrinsics
    host = TGS.fetch_solved(t_solved)
    for k, b in enumerate(t_builts):
        pg = TGS.extract_group_params(t_batch, host, k)
        want = JGS.extract_group_params(j_batch, JGS.fetch_solved(j_solved), k)
        assert pg.quats.shape == (b.params.C, 4) and pg.mesh_z.shape == (b.params.V,) and pg.focal.shape == (2,)
        assert pg.quats.shape == np.asarray(want.quats).shape and pg.focal.shape == np.asarray(want.focal).shape


def test_refreshed_batch_equals_rebuilt_batch(survey):
    """A cached batch whose builts were refreshed under a later tier (moved
    poses, heights and models) restacks to what a batch built from equally
    refreshed, never batched builts gives, but for the monotonicity prior,
    which keeps its first build's weight and ``r_max`` as in the reference;
    and it warm-starts from the previous solve's dampings."""
    graph, ids, j_models, groups, previous = survey
    _, cached = _builts(survey, 0)
    fresh = copy.deepcopy(cached)
    batch = TGS.build_group_batch(cached, shared_intrinsics=True)
    batch.warm_lambda = (torch.tensor([3e-9, 5e4], dtype=F64), torch.tensor(0.25, dtype=F64))

    rng = np.random.default_rng(21)
    t_graph = interop.graph_from(graph)
    moved_models = {}
    for mid, m in j_models.items():
        moved_models[mid] = m.replace(focal_length_pixels=m.focal_length_pixels * 1.01,
                                      radial_distortion=m.radial_distortion + jnp.asarray([0.004, 0.0, 0.0]))
    t_models = interop.model_store_from(moved_models)
    mesh = interop.mesh_from(previous[0].mesh)
    mesh.vertices[:, 2] += rng.normal(scale=0.2, size=mesh.num_vertices)
    surfaces = [TG.SurfaceModel(cloud=[], mesh=mesh)]
    opts = TPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[2])
    for builts in (cached, fresh):
        for b, (node_ids, mids, _) in zip(builts, groups):
            poses = _node_poses(t_graph, node_ids, TG)
            for p in poses:
                p.orientation = p.orientation + 1e-3
                p.orientation /= np.linalg.norm(p.orientation)
            assert TPB.refresh_problem(b, t_graph, poses, {m: t_models[m] for m in mids}, surfaces, opts)
    refreshed = TGS.refresh_group_batch(batch)
    rebuilt = TGS.build_group_batch(fresh, shared_intrinsics=True)
    assert refreshed.warm_lambda is batch.warm_lambda and refreshed.model_perms is batch.model_perms
    assert torch.equal(refreshed.free, rebuilt.free) and torch.equal(refreshed.surface_free, rebuilt.surface_free)
    assert not torch.equal(refreshed.free, batch.free)  # the tier moved the mask
    # a refresh reads the models a group lists; group B does not list model 1, so its copy of that
    # model's leaves (which none of its blocks reads) is left out of the comparison
    owned = torch.tensor([[True, True], [False, True]])

    def same(x, y, f):
        if f in INTRINSICS:
            return torch.equal(getattr(x, f)[owned], getattr(y, f)[owned])
        return torch.equal(getattr(x, f), getattr(y, f))

    for f in FIELDS:
        assert same(refreshed.params, rebuilt.params, f), f
    for a, b, c in zip(refreshed.blocks, rebuilt.blocks, batch.blocks):
        assert a.name == b.name and torch.equal(a.slots, b.slots), a.name
        if a.name == "monotonicity":  # carried over from the cached batch
            assert torch.equal(a.weight, c.weight) and torch.equal(a.data["r_max"], c.data["r_max"])
            assert float(a.weight.sum()) == 0.0 and float(b.weight.sum()) == 3.0  # the tier's switch, not restacked
            continue
        assert torch.equal(a.weight, b.weight), a.name
        for k in a.data:
            assert torch.equal(a.data[k], b.data[k]), f"{a.name}.{k}"
    # equal batches solve alike; the warm start (clipped into [1e-6, 1e2]) is used
    rebuilt.blocks = tuple(a if a.name == "monotonicity" else b for a, b in zip(refreshed.blocks, rebuilt.blocks))
    rebuilt.warm_lambda = batch.warm_lambda
    a, info_a = TGS.solve_group_batch_shared(refreshed, pre_solve=False, max_iterations=5)
    b, info_b = TGS.solve_group_batch_shared(rebuilt, pre_solve=False, max_iterations=5)
    for f in FIELDS:
        assert same(a, b, f), f
    assert int(info_a.iterations) == int(info_b.iterations) == 5
    cold = TGS.build_group_batch(copy.deepcopy(fresh), shared_intrinsics=True)
    _, info_c = TGS.solve_group_batch_shared(cold, pre_solve=False, max_iterations=1)
    _, info_w = TGS.solve_group_batch_shared(rebuilt, pre_solve=False, max_iterations=1)
    assert float(info_c.final_lambda) != float(info_w.final_lambda)


FOLDED_RADIAL = (-2.0, 0.0, 0.0)  # 1 + 3 k1 r^2 < 0 from r = 0.41, inside r_max = 0.5 (320 x 240 at f 400)
REFRESH_REL = 1e-9


def test_refresh_keeps_the_monotonicity_prior_of_the_first_build_as_the_reference(survey):
    """One refresh and one solve of a two-group batch against the JAX
    package's, in float64. The batch is built at the focal tier (prior
    weight 0), refreshed under the second radial tier (which switches the
    prior on in a fresh build) and solved from a radial polynomial that folds
    inside the image, where a restacked prior would not be zero. The
    reference restacks only the mesh-anchor targets, so its prior stays off;
    so does the port's."""
    graph, ids, j_models, groups, previous = survey
    j_builts, t_builts = _builts(survey, 0)
    j_batch = JGS.build_group_batch(j_builts, shared_intrinsics=True)
    t_batch = TGS.build_group_batch(t_builts, shared_intrinsics=True)
    moved = {mid: m.replace(focal_length_pixels=m.focal_length_pixels * 1.01) for mid, m in j_models.items()}
    t_models, t_graph = interop.model_store_from(moved), interop.graph_from(graph)
    opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[2])
    opts_t = interop.relax_options_from(opts_j)
    for jb, tb, (node_ids, mids, _) in zip(j_builts, t_builts, groups):
        assert JPB.refresh_problem(jb, graph, _node_poses(graph, node_ids, JG), {m: moved[m] for m in mids},
                                   previous, opts_j)
        assert TPB.refresh_problem(tb, t_graph, _node_poses(t_graph, node_ids, TG), {m: t_models[m] for m in mids},
                                   [interop.surface_from(p) for p in previous], opts_t)
    j_ref, t_ref = JGS.refresh_group_batch(j_batch), TGS.refresh_group_batch(t_batch)
    _assert_same_batch(t_ref, j_ref)
    mono = next(b for b in t_ref.blocks if b.name == "monotonicity")
    assert float(mono.weight.sum()) == 0.0  # the first build's switch
    restacked = next(b for b in TGS.build_group_batch(copy.deepcopy(t_builts), shared_intrinsics=True).blocks
                     if b.name == "monotonicity")
    assert float(restacked.weight.sum()) == 3.0  # a fresh build at this tier switches it on

    # one solve each from the same parameters, the radial terms folded
    radial = np.broadcast_to(np.asarray(FOLDED_RADIAL), np.asarray(j_ref.params.radial).shape).copy()
    j_ref.params = dataclasses.replace(j_ref.params, radial=jnp.asarray(radial))
    t_ref.params = interop.relax_params_from(j_ref.params, "cpu")
    assert float(TLM.block_cost(TGS._group(t_ref.params, 0), TGS._group(restacked, 0))) > 0  # restacked, it bites
    j_solved, j_info = JGS.solve_group_batch_shared(j_ref, pre_solve=False, max_iterations=1)
    t_solved, t_info = TGS.solve_group_batch_shared(t_ref, pre_solve=False, max_iterations=1)
    got, want = _solved_numpy(TGS.fetch_solved(t_solved)), _solved_numpy(JGS.fetch_solved(j_solved))
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=REFRESH_REL, atol=REFRESH_REL, err_msg=f)
    np.testing.assert_allclose(float(t_info.final_cost), float(np.ravel(np.asarray(j_info.final_cost))[0]),
                               rtol=REFRESH_REL)
    assert not np.array_equal(got["quats"], np.asarray(t_ref.params.quats))  # the step moved


# ---------------------------------------------------------------------------
# The synthetic points problem of the reference's own solver tests
# ---------------------------------------------------------------------------


def _points_builts(G=4, shift_group0=0.0):
    """The reference's synthetic groups in float64, as (JAX builts, port
    builts); ``shift_group0`` moves group 0's camera positions (a far-off
    start whose first steps are rejected)."""
    j_builts, _ = _synthetic_builts(G=G)
    to64 = lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)  # noqa: E731
    out_j, out_t = [], []
    for g, b in enumerate(j_builts):
        params = jax.tree.map(lambda x: jnp.asarray(to64(x)), b.params)
        if g == 0 and shift_group0:
            params = dataclasses.replace(params, positions=params.positions + shift_group0)
        blk = b.blocks[0]
        j_blk = dataclasses.replace(blk, data={k: jnp.asarray(to64(v)) for k, v in blk.data.items()},
                                    weight=jnp.asarray(to64(blk.weight)))
        out_j.append(dataclasses.replace(b, params=params, blocks=[j_blk]))
        layout = TangentLayout(b.layout.C, b.layout.V, b.layout.P, b.layout.M)
        d = interop.block_data_from(j_blk.data, "cpu")
        t_blk = TB.pixel_error_block(layout, d["cam_i"], d["point_i"], d["model_i"], d["pixel"],
                                     interop.to_torch(j_blk.weight, "cpu"))
        np.testing.assert_array_equal(t_blk.slots.numpy(), np.asarray(blk.slots))
        assert t_blk.huber_delta == blk.huber_delta and t_blk.num_residuals == blk.num_residuals
        out_t.append(TPB.BuiltProblem(
            params=interop.relax_params_from(params, "cpu"), layout=layout, blocks=[t_blk],
            free_mask=interop.to_torch(b.free_mask, "cpu"), surface_free_mask=torch.zeros(layout.dim, dtype=torch.bool),
            cam_index={}, model_index={7: 0}, mesh=None, inverse_models=False,
            track_points=np.zeros((0, 3)), track_errors=np.zeros(0),
        ))
    return out_j, out_t


def test_shared_solve_of_the_points_problem_matches_reference():
    """Only the intrinsics are shared (points are group-local); no pre-solve."""
    j_builts, t_builts = _points_builts()
    j_batch = JGS.build_group_batch(j_builts, shared_intrinsics=True)
    t_batch = TGS.build_group_batch(t_builts, shared_intrinsics=True)
    _assert_same_batch(t_batch, j_batch)
    j_solved, j_info = JGS.solve_group_batch_shared(j_batch, pre_solve=False, max_iterations=40)
    t_solved, t_info = TGS.solve_group_batch_shared(t_batch, pre_solve=False, max_iterations=40)
    _assert_same_solution(t_solved, JGS.fetch_solved(j_solved), t_info, j_info)
    focal = TGS.extract_group_params(t_batch, TGS.fetch_solved(t_solved), 0).focal[0]
    assert abs(float(focal) - 600.0) < 1.0  # the truth; the start is 612
    for g in range(1, 4):
        assert torch.equal(t_solved.focal[g], t_solved.focal[0])


def _joint_solve(builts, max_iterations):
    """One dense LM over the concatenated groups: the joint problem itself."""
    G, C, P = len(builts), builts[0].params.C, builts[0].params.P
    layout = TangentLayout(G * C, 0, G * P, 1)
    p0 = builts[0].params
    cat = lambda f: torch.cat([getattr(b.params, f) for b in builts])  # noqa: E731
    joint = RelaxParams(quats=cat("quats"), positions=cat("positions"), mesh_z=p0.mesh_z, points=cat("points"),
                        focal=p0.focal, principal=p0.principal, radial=p0.radial, tangential=p0.tangential)
    data = lambda k, off=0: torch.cat([b.blocks[0].data[k] + g * off for g, b in enumerate(builts)])  # noqa: E731
    blk = TB.pixel_error_block(layout, data("cam_i", C), data("point_i", P), data("model_i"), data("pixel"),
                               torch.cat([b.blocks[0].weight for b in builts]))
    free = layout.build_free_mask(points_free=True, focal_free=True, device="cpu")
    return TLM.solve(joint, [blk], layout, free, max_iterations=max_iterations, linear_solver="cholesky")


def test_shared_solver_matches_one_joint_dense_solve():
    """The Schur-coupled solve over the groups is the dense solve of the
    concatenated problem: same focal, the same in every group."""
    _, builts = _points_builts()
    joint, _ = _joint_solve(builts, 40)
    batch = TGS.build_group_batch(builts, shared_intrinsics=True)
    assert batch.shared_intrinsics and batch.layout.M == 1
    solved, info = TGS.solve_group_batch_shared(batch, pre_solve=False, max_iterations=40)
    focal_joint, focal_shared = float(joint.focal[0]), float(solved.focal[0, 0])
    print(f"joint dense focal {focal_joint:.6f}, shared {focal_shared:.6f}, {int(info.iterations)} iterations")
    assert abs(focal_joint - 600.0) < 1.0 and abs(focal_shared - 600.0) < 1.0
    assert abs(focal_shared - focal_joint) < 0.2
    assert np.isfinite(float(info.final_cost))


def test_shared_solver_per_group_trust_region():
    """One group starts far off (its camera positions moved 25 m, its
    measurements still consistent), so the first joint steps are rejected:
    with per-group local damping the joint problem still converges within
    the budget, and the shared focal lands near the truth."""
    j_builts, t_builts = _points_builts(shift_group0=25.0)
    t_batch = TGS.build_group_batch(t_builts, shared_intrinsics=True)
    t_solved, t_info = TGS.solve_group_batch_shared(t_batch, pre_solve=False, max_iterations=60)
    assert float(t_info.initial_cost) > 1e4
    assert float(t_info.final_cost) < 10.0, float(t_info.final_cost)
    assert abs(float(t_solved.focal[1, 0]) - 600.0) < 5.0
    lam_l = t_batch.warm_lambda[0]
    assert lam_l.shape == (4,) and len(set(lam_l.tolist())) > 1  # the groups' dampings parted
    # and the same trajectory as the reference's: cost and focal, iteration for iteration
    j_batch = JGS.build_group_batch(j_builts, shared_intrinsics=True)
    j_solved, j_info = JGS.solve_group_batch_shared(j_batch, pre_solve=False, max_iterations=60)
    assert int(t_info.iterations) == int(np.ravel(np.asarray(j_info.iterations))[0])
    np.testing.assert_allclose(float(t_solved.focal[0, 0]), float(np.asarray(j_solved.focal)[0, 0]), rtol=SOLVE_REL)
