"""Parity of the port's camera-parameter relax pieces with the JAX package, in
float64 on the CPU: the radial monotonicity block, the intrinsics (pixel)
form of the plane-ray block away from delta = 0, ``build_mesh_problem`` under
each of the four option tiers of CAMERA_PARAMETER_RELAX, ``refresh_problem``
along that schedule, ``apply_solution`` writing a changed camera model, and
``refit_all_edges``.

Tolerances: block residuals and Jacobians 1e-12 (absolute plus relative);
built and refreshed problems with slots, masks, integer data and
``model_index`` equal, poses, heights and float block data within 1e-12
(absolute plus relative), and the intrinsics leaves within 1e-7 absolute:
they hold INVERSE models, which each package fits to the FORWARD ones by its
own 50-step iterative solve, and the two stop up to 1e-8 apart; the FORWARD
model written back within 1e-7 absolute for the same reason; refitted edges
with inlier sets equal and homographies, poses and scores within 1e-9.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import distort as JD
from opencalibration_tpu.pipeline import stages as JS
from opencalibration_tpu.relax import blocks as JB
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax import tangent as JT
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu.types.graph import SurfaceModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.pipeline import stages as TS
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax import tangent as TT
from opencalibration_tpu_torch.types import graph as TG
from tests.test_torch_ground_mesh import _grid_mesh, _poses, _tracked_graph
from tests.test_torch_ground_plane import BROWN, _jcam, _plane_ray_inputs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
BLOCK_TOL = dict(rtol=1e-12, atol=1e-12)
# the four option sets CAMERA_PARAMETER_RELAX steps through
TIERS = [
    dict(focal=True),
    dict(focal=True, radial_tier=1),
    dict(focal=True, radial_tier=2),
    dict(focal=True, principal=True, radial_tier=3),
]


def _t(x):
    return torch.as_tensor(np.array(x))


def _resid_and_jacobian(j_blk, t_blk, j_params, t_params, delta):
    """Every instance's residual and Jacobian at ``delta``, (JAX, port)."""
    j_data = {k: jnp.asarray(v) for k, v in j_blk.data.items()}
    d_j = jnp.asarray(delta)
    ref_r = np.asarray(jax.vmap(lambda d: j_blk.resid_one(d_j, d, j_params))(j_data))
    ref_J = np.asarray(jax.vmap(lambda d: jax.jacfwd(lambda dl: j_blk.resid_one(dl, d, j_params))(d_j))(j_data))
    d_t = _t(delta)
    got_r = torch.func.vmap(lambda d: t_blk.resid_one(d_t, d, t_params))(t_blk.data).numpy()
    got_J = torch.func.vmap(lambda d: torch.func.jacfwd(lambda dl: t_blk.resid_one(dl, d, t_params))(d_t))(
        t_blk.data).numpy()
    return (ref_r, ref_J), (got_r, got_J)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta_scale", [0.0, 0.005], ids=["at_zero", "with_delta"])
def test_monotonicity_block_residuals_and_jacobians(delta_scale):
    """Three models: a mild one (derivative positive everywhere, residual 0),
    a strong barrel (k1 = -0.9) and a mixed one whose derivative turns
    negative only near r_max."""
    rng = np.random.default_rng(11)
    radial = np.asarray([[0.02, -0.003, 0.0], [-0.9, 0.1, -0.02], [-0.45, 0.02, -0.06]])
    r_max = np.asarray([0.5, 0.9, 1.1])
    obs_w = np.asarray([3.0, 5.0, 7.0])
    quats = np.tile([0.0, 1.0, 0.0, 0.0], (2, 1))
    kw = dict(focal=np.full(3, 400.0), principal=np.zeros((3, 2)), radial=radial, tangential=np.zeros((3, 2)))
    j_params = JT.RelaxParams.create(jnp.asarray(quats), jnp.zeros((2, 3)), dtype=jnp.float64, **kw)
    t_params = TT.RelaxParams.create(_t(quats), torch.zeros(2, 3, dtype=F64), dtype=F64,
                                     **{k: _t(v) for k, v in kw.items()})
    jl, tl = JT.TangentLayout(2, 0, 0, 3), TT.TangentLayout(2, 0, 0, 3)
    idx = np.asarray([0, 1, 2])
    j_blk = JB.monotonicity_block(jl, idx.astype(np.int32), r_max, obs_w, np.ones(3))
    t_blk = TB.monotonicity_block(tl, _t(idx), _t(r_max), _t(obs_w), torch.ones(3, dtype=F64))
    assert t_blk.name == j_blk.name == "monotonicity" and t_blk.num_residuals == j_blk.num_residuals == 10
    assert t_blk.huber_delta is None and j_blk.huber_delta is None
    np.testing.assert_array_equal(t_blk.slots.numpy(), np.asarray(j_blk.slots))
    np.testing.assert_array_equal(t_blk.slots.numpy(), tl.radial_off + np.arange(9).reshape(3, 3))
    delta = delta_scale * rng.normal(size=3)
    (ref_r, ref_J), (got_r, got_J) = _resid_and_jacobian(j_blk, t_blk, j_params, t_params, delta)
    assert (ref_r[0] == 0).all() and (ref_r[1] > 0).any() and (ref_r[2] > 0).any() and (ref_r[2] == 0).any()
    np.testing.assert_allclose(got_r, ref_r, **BLOCK_TOL)
    np.testing.assert_allclose(got_J, ref_J, **BLOCK_TOL)


def test_plane_ray_intrinsics_branch_with_delta():
    """The pixel form of the plane-ray block at a step that moves the focal
    length, the principal point and the radial terms (and heights and
    rotations): residuals and Jacobians with respect to all 24 local slots."""
    rng = np.random.default_rng(12)
    inv = JD.convert_to_inverse(_jcam(**BROWN))
    x = _plane_ray_inputs(rng, "pixel", inv)
    keep = slice(0, x["B"] - 1)  # without the parallel-ray (NaN) instance, which is held at delta = 0 elsewhere
    kw = dict(focal=np.asarray([400.0, 417.0]), principal=np.asarray([[163.0, 118.0], [158.0, 121.5]]),
              radial=np.stack([np.asarray(inv.radial_distortion), [0.03, -0.01, 0.002]]),
              tangential=np.stack([np.asarray(inv.tangential_distortion), [0.0, 0.0]]))
    model_i = rng.integers(0, 2, size=x["B"])
    jl, tl = JT.TangentLayout(x["C"], x["V"], 0, 2), TT.TangentLayout(x["C"], x["V"], 0, 2)
    j_params = JT.RelaxParams.create(jnp.asarray(x["quats"]), x["positions"], mesh_z=x["mesh_z"],
                                     dtype=jnp.float64, **kw)
    t_params = TT.RelaxParams.create(_t(x["quats"]), _t(x["positions"]), mesh_z=_t(x["mesh_z"]), dtype=F64,
                                     **{k: _t(v) for k, v in kw.items()})
    j_blk = JB.plane_ray_block(jl, x["vert_idx"][keep].astype(np.int32), x["tri_xy"][keep],
                               x["cam_idx"][keep].astype(np.int32), x["ray_valid"][keep], np.ones(x["B"] - 1),
                               model_i=model_i[keep].astype(np.int32), pixel=x["pixel"][keep])
    t_blk = TB.plane_ray_block(tl, _t(x["vert_idx"][keep]), _t(x["tri_xy"][keep]), _t(x["cam_idx"][keep]),
                               _t(x["ray_valid"][keep]), torch.ones(x["B"] - 1, dtype=F64),
                               model_i=_t(model_i[keep]), pixel=_t(x["pixel"][keep]))
    np.testing.assert_array_equal(t_blk.slots.numpy(), np.asarray(j_blk.slots))
    assert t_blk.resid_one.__name__ == j_blk.resid_one.__name__
    delta = np.concatenate([rng.normal(scale=0.2, size=3), [6.5], [1.5, -2.0], [0.01, -0.004, 0.001],
                            rng.normal(scale=0.01, size=15)])
    (ref_r, ref_J), (got_r, got_J) = _resid_and_jacobian(j_blk, t_blk, j_params, t_params, delta)
    assert np.isfinite(ref_r).all() and np.abs(ref_J[:, :, 3:9]).max() > 0  # the intrinsics columns are live
    np.testing.assert_allclose(got_r, ref_r, **BLOCK_TOL)
    np.testing.assert_allclose(got_J, ref_J, **BLOCK_TOL)
    # and it is not the fixed-direction form: the step on the focal moves the residual
    at_zero = _resid_and_jacobian(j_blk, t_blk, j_params, t_params, np.zeros(24))[1][0]
    assert np.abs(got_r - at_zero).max() > 1e-4


# ---------------------------------------------------------------------------
# build_mesh_problem, refresh_problem, apply_solution
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tracked():
    """The 2 x 3 relief survey of tests/test_torch_ground_mesh.py with TWO
    camera models: the first row's images keep model 1, the second row's
    take model 2 (another focal and distortion)."""
    graph, ids, j_models = _tracked_graph()
    j_models[2] = JCameraModel.create(395.0, (161.0, 119.0), (-0.05, 0.01, 0.0), (0.0, 0.0), 320, 240,
                                      dtype=jnp.float64)
    for nid in ids[3:]:
        graph.get_node(nid).payload.model_id = 2
    return graph, interop.graph_from(graph), ids, j_models, interop.model_store_from(j_models)


def _previous():
    rng = np.random.default_rng(7)
    cloud = np.column_stack([rng.uniform(-10, 40, 50), rng.uniform(-10, 30, 50), rng.normal(size=50)])
    return [SurfaceModel(cloud=[cloud], mesh=_grid_mesh(rng, z_scale=0.8))]


def _assert_same_built(got, ref):
    """Structure exactly, intrinsics leaves within CONVERSION_TOL, the other
    float leaves and data within BLOCK_TOL."""
    assert got.cam_index == ref.cam_index and got.model_index == ref.model_index
    assert (got.layout.C, got.layout.V, got.layout.P, got.layout.M) == \
        (ref.layout.C, ref.layout.V, ref.layout.P, ref.layout.M)
    assert (got.kind, got.num_opt, got.v_real, got.inverse_models) == \
        (ref.kind, ref.num_opt, ref.v_real, ref.inverse_models)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(ref.free_mask))
    np.testing.assert_array_equal(got.surface_free_mask.numpy(), np.asarray(ref.surface_free_mask))
    for f, v in interop.relax_params_to_numpy(got.params).items():
        tol = CONVERSION_TOL if f in ("focal", "principal", "radial", "tangential") else BLOCK_TOL
        np.testing.assert_allclose(v, np.asarray(getattr(ref.params, f)), err_msg=f, **tol)
    assert [b.name for b in got.blocks] == [b.name for b in ref.blocks]
    for gb, rb in zip(got.blocks, ref.blocks):
        assert gb.resid_one.__name__ == rb.resid_one.__name__ and gb.huber_delta == rb.huber_delta
        np.testing.assert_array_equal(gb.slots.numpy(), np.asarray(rb.slots))
        np.testing.assert_array_equal(gb.weight.numpy(), np.asarray(rb.weight))
        assert set(gb.data) == set(rb.data)
        for k, v in gb.data.items():
            want = np.asarray(rb.data[k])
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{rb.name}.{k}")
            else:
                np.testing.assert_allclose(v.numpy(), want, err_msg=f"{rb.name}.{k}", **BLOCK_TOL)


# a model that went through ``convert_to_inverse`` / ``convert_to_forward``:
# each package's own iterative fit, equal to its convergence floor
CONVERSION_TOL = dict(rtol=0, atol=1e-7)


@pytest.mark.parametrize("tier", range(4), ids=["focal", "radial1", "radial2", "radial3_principal"])
def test_build_mesh_problem_with_intrinsics(tracked, tier):
    graph, t_graph, ids, j_models, t_models = tracked
    edge_ids = sorted(graph.edge_ids())
    opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[tier])
    opts_t = interop.relax_options_from(opts_j)
    assert opts_t.any_intrinsics and (opts_t.focal, opts_t.principal, opts_t.radial_tier) == \
        (opts_j.focal, opts_j.principal, opts_j.radial_tier)
    prev = _previous()
    ref = JPB.build_mesh_problem(graph, _poses(graph, ids), j_models, edge_ids, opts_j, prev, 0.1)
    got = TPB.build_mesh_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids, opts_t,
                                 [interop.surface_from(s) for s in prev], 0.1, dtype=F64, device="cpu")
    _assert_same_built(got, ref)
    names = [b.name for b in got.blocks]
    assert names[0] == "plane_ray" and names[-1] == "monotonicity" and "pixel" in got.blocks[0].data
    assert got.model_index == {1: 0, 2: 1}
    assert set(np.unique(got.blocks[0].data["model_i"].numpy())) == {0, 1}
    # the monotonicity prior is always there and gated by its weight
    mono = got.blocks[-1]
    assert float(mono.weight.sum()) == (2.0 if tier > 0 else 0.0)
    # the free mask frees exactly what the tier names, for both models
    lay = got.layout
    free = got.free_mask.numpy()
    assert free[lay.focal_off : lay.focal_off + 2].all()
    assert free[lay.principal_off : lay.principal_off + 4].all() == (tier == 3)
    np.testing.assert_array_equal(free[lay.radial_off : lay.radial_off + 6].reshape(2, 3),
                                  np.tile(np.arange(3) < tier, (2, 1)))
    assert not free[lay.tangential_off :].any()


def test_refresh_problem_across_the_tier_schedule(tracked):
    """One structure built under the first tier, refreshed under each later
    one with moved poses, mesh heights and camera models, on both sides."""
    graph, t_graph, ids, j_models, t_models = tracked
    edge_ids = sorted(graph.edge_ids())
    j_models, t_models = dict(j_models), dict(t_models)
    opts0 = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[0])
    prev = _previous()
    ref = JPB.build_mesh_problem(graph, _poses(graph, ids), j_models, edge_ids, opts0, prev, 0.1)
    got = TPB.build_mesh_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids,
                                 interop.relax_options_from(opts0), [interop.surface_from(s) for s in prev], 0.1,
                                 dtype=F64, device="cpu")
    structure = [(b.name, tuple(b.slots.shape)) for b in got.blocks]
    rng = np.random.default_rng(13)
    for tier in (1, 2, 3):
        opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[tier])
        poses = _poses(graph, ids)
        for p in poses:
            p.orientation = np.asarray(p.orientation) + rng.normal(scale=1e-3, size=4)
            p.orientation /= np.linalg.norm(p.orientation)
        moved = ref.mesh.copy()
        moved.vertices[:, 2] += rng.normal(scale=0.2, size=moved.num_vertices)
        surfaces = [SurfaceModel(cloud=[], mesh=moved)]
        # the models move as a solve would move them: focal and radial terms
        for mid in j_models:
            m = j_models[mid]
            j_models[mid] = m.replace(
                focal_length_pixels=m.focal_length_pixels * (1.0 + 0.01 * tier),
                radial_distortion=m.radial_distortion + jnp.asarray([0.01 * tier, -0.002, 0.0]),
            )
        t_models = interop.model_store_from(j_models)
        assert JPB.refresh_problem(ref, graph, poses, j_models, surfaces, opts_j)
        assert TPB.refresh_problem(got, t_graph, interop.node_poses_from(poses), t_models,
                                   [interop.surface_from(s) for s in surfaces], interop.relax_options_from(opts_j))
        _assert_same_built(got, ref)
        assert [(b.name, tuple(b.slots.shape)) for b in got.blocks] == structure
        mono = got.blocks[-1]
        np.testing.assert_array_equal(mono.weight.numpy(), np.ones(2))
        # r_max follows the current focal: half the diagonal over the focal
        want = [np.hypot(320, 240) / 2 / float(j_models[mid].focal_length_pixels) for mid in (1, 2)]
        np.testing.assert_allclose(mono.data["r_max"].numpy(), want, rtol=1e-12)
        free = got.free_mask.numpy()
        np.testing.assert_array_equal(free[got.layout.radial_off : got.layout.radial_off + 3], np.arange(3) < tier)


def test_apply_solution_writes_a_changed_model(tracked):
    graph, t_graph, ids, j_models, t_models = tracked
    edge_ids = sorted(graph.edge_ids())
    opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1, **TIERS[3])
    prev = _previous()
    ref = JPB.build_mesh_problem(graph, _poses(graph, ids), j_models, edge_ids, opts_j, prev, 0.1)
    got = TPB.build_mesh_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids,
                                 interop.relax_options_from(opts_j), [interop.surface_from(s) for s in prev], 0.1,
                                 dtype=F64, device="cpu")
    # a "solved" state: model 2's inverse leaves moved, model 1's untouched
    solved = interop.relax_params_to_numpy(got.params)
    solved["focal"][1] *= 1.02
    solved["principal"][1] += [0.8, -0.5]
    solved["radial"][1] += [0.01, -0.003, 0.0005]
    solved["quats"][0] = [0.0, 0.6, 0.8, 0.0]
    j_solved = JT.RelaxParams(**{k: jnp.asarray(v) for k, v in solved.items()})
    t_solved = TT.RelaxParams(**solved)
    j_out, t_out = dict(j_models), dict(t_models)
    j_poses, t_poses = _poses(graph, ids), _poses(t_graph, ids, TG)
    j_surface = JPB.apply_solution(ref, j_solved, j_poses, j_out)
    t_surface = TPB.apply_solution(got, t_solved, t_poses, t_out)
    np.testing.assert_array_equal(t_poses[0].orientation, j_poses[0].orientation)
    np.testing.assert_allclose(t_surface.mesh.vertices, j_surface.mesh.vertices, rtol=0, atol=1e-12)
    # model 1's leaves are its own inverse: the reference's change test
    # (radial against minus the FORWARD radial) sees a distorted model as
    # changed, and both sides convert it back alike
    for mid in (1, 2):
        want, have = j_out[mid], t_out[mid]
        assert have.tag == want.tag == "forward" and have.dtype == F64
        assert have.focal_length_pixels.device.type == "cpu"
        for leaf in ("focal_length_pixels", "principal_point", "radial_distortion", "tangential_distortion",
                     "pixels_cols", "pixels_rows"):
            np.testing.assert_allclose(getattr(have, leaf).numpy(), np.asarray(getattr(want, leaf)),
                                       err_msg=f"model {mid} {leaf}", **CONVERSION_TOL)
    assert abs(float(t_out[2].focal_length_pixels) / float(t_models[2].focal_length_pixels) - 1.02) < 1e-9
    assert t_out[2] is not t_models[2]
    # without a store, or with unchanged distortion-free leaves, nothing is written
    TPB.apply_solution(got, TT.RelaxParams(**interop.relax_params_to_numpy(got.params)), t_poses, None)
    plain = {1: interop.camera_from(_jcam(), "cpu")}
    flat_built = copy.copy(got)
    flat_built.model_index = {1: 0}
    same = interop.relax_params_to_numpy(got.params)
    same["focal"][0], same["radial"][0] = 400.0, 0.0
    store = dict(plain)
    TPB.apply_solution(flat_built, TT.RelaxParams(**same), t_poses, store)
    assert store[1] is plain[1]


# ---------------------------------------------------------------------------
# refit_all_edges
# ---------------------------------------------------------------------------


def _graph_with_matches(seed=14, short_edges=True):
    """The tracked survey's graph with match lists as the link stage leaves
    them: each edge's inliers first, then 40 wrong pairs; with
    ``short_edges`` every third edge's inlier match list is cut to 5 (an edge
    the refit has to grow back), which only the refit reads."""
    graph, ids, j_models = _tracked_graph()
    rng = np.random.default_rng(seed)
    for k, (_, e) in enumerate(sorted(graph.edges())):
        rel = e.payload
        n1 = len(graph.get_node(e.source).payload.features.xy)
        n2 = len(graph.get_node(e.dest).payload.features.xy)
        n_inl = 5 if short_edges and k % 3 == 0 else len(rel.inlier_idx1)
        rel.match_idx1 = np.concatenate([rel.inlier_idx1, rng.integers(0, n1, 40)]).astype(np.int32)
        rel.match_idx2 = np.concatenate([rel.inlier_idx2, rng.integers(0, n2, 40)]).astype(np.int32)
        rel.match_distance = rng.uniform(0.0, 0.3, len(rel.match_idx1)).astype(np.float32)
        rel.inlier_match_index = np.arange(n_inl, dtype=np.int32)
    return graph, ids, j_models


def test_refit_all_edges_matches_reference():
    graph, ids, j_models = _graph_with_matches()
    # the calibrated model differs from the one the edges were fitted with
    m = j_models[1]
    j_models = {1: m.replace(focal_length_pixels=m.focal_length_pixels * 1.03,
                             radial_distortion=m.radial_distortion + jnp.asarray([0.02, -0.005, 0.0]))}
    t_graph = interop.graph_from(graph)
    t_models = interop.model_store_from(j_models)
    before = {eid: len(e.payload.inlier_match_index) for eid, e in graph.edges()}
    JS.refit_all_edges(graph, j_models)
    TS.refit_all_edges(t_graph, t_models, dtype=F64, device="cpu")
    kept = emptied = 0
    for eid, e in sorted(graph.edges()):
        want, have = e.payload, t_graph.get_edge(eid).payload
        for name in ("inlier_idx1", "inlier_idx2", "inlier_match_index"):
            np.testing.assert_array_equal(getattr(have, name), getattr(want, name), err_msg=f"edge {eid} {name}")
            assert getattr(have, name).dtype == getattr(want, name).dtype
        np.testing.assert_array_equal(have.inlier_pixel1, want.inlier_pixel1)
        np.testing.assert_array_equal(have.inlier_pixel2, want.inlier_pixel2)
        assert have.relation_type == want.relation_type
        np.testing.assert_allclose(have.ransac_relation, want.ransac_relation, rtol=1e-9, atol=1e-9)
        # candidates are ordered by a stable sort on -score on both sides
        np.testing.assert_allclose(have.rel_scores, want.rel_scores, rtol=0, atol=1e-9)
        np.testing.assert_allclose(have.rel_positions, want.rel_positions, rtol=0, atol=1e-9)
        flip = np.sign(np.sum(np.asarray(have.rel_quats) * np.asarray(want.rel_quats), axis=-1, keepdims=True))
        np.testing.assert_allclose(flip * have.rel_quats, want.rel_quats, rtol=0, atol=1e-9)
        assert (np.diff(have.rel_scores) <= 0).all()
        kept += len(have.inlier_idx1) > 0
        emptied += len(have.inlier_idx1) == 0
        assert np.isfinite(have.ransac_relation).all()
    # the three rounds grow a 5-inlier edge back to its geometry's inliers
    grown = [eid for eid, e in t_graph.edges() if before[eid] == 5 and len(e.payload.inlier_idx1) > 6]
    print(f"refit: {kept} edges kept inliers, {emptied} emptied, {len(grown)} grew from 5 inliers")
    assert kept >= 6 and grown


def test_refit_empties_an_edge_without_support():
    """More than 6 inliers and a best pose score above 0, or the edge's
    inlier lists are emptied (its matches stay)."""
    graph, ids, j_models = _graph_with_matches()
    eid, e = sorted(graph.edges())[1]
    rel = e.payload
    rng = np.random.default_rng(15)
    n1 = len(graph.get_node(e.source).payload.features.xy)
    n2 = len(graph.get_node(e.dest).payload.features.xy)
    # matches that share no geometry: whatever 4+ "inliers" seed the refit, no more than a handful agree
    rel.match_idx1 = rng.integers(0, n1, 60).astype(np.int32)
    rel.match_idx2 = rng.integers(0, n2, 60).astype(np.int32)
    rel.match_distance = rng.uniform(0, 0.3, 60).astype(np.float32)
    rel.inlier_match_index = np.arange(8, dtype=np.int32)
    t_graph = interop.graph_from(graph)
    JS.refit_all_edges(graph, j_models)
    TS.refit_all_edges(t_graph, interop.model_store_from(j_models), dtype=F64, device="cpu")
    want, have = graph.get_edge(eid).payload, t_graph.get_edge(eid).payload
    assert len(want.inlier_idx1) == 0 and len(have.inlier_idx1) == 0
    for name in ("inlier_idx1", "inlier_idx2", "inlier_pixel1", "inlier_pixel2", "inlier_match_index"):
        assert getattr(have, name).shape == getattr(want, name).shape
        assert getattr(have, name).dtype == getattr(want, name).dtype
    assert len(have.match_idx1) == 60
