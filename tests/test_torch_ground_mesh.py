"""Parity of the port's ground-mesh relax pieces (the mesh-prior block
families, the multi-ray track builder, the ground-mesh problem builder and
``refresh_problem``) with the JAX package, in float64.

Tolerances: mesh-prior residuals and per-instance Jacobians within 1e-9;
track rows equal (fixed ray directions within 1e-9), with equal used
measurements and covered cells; built and refreshed problems equal (block
arrays, slots, free masks, anchor targets within 1e-9); solved orientations
and mesh heights within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import distort as JD
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.relax import blocks as JB
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax import tangent as JT
from opencalibration_tpu.relax.tracks import build_multiray_tracks as j_tracks
from opencalibration_tpu.surface.mesh import TriMesh
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.graph import (
    CameraRelations,
    FeatureSet,
    ImageNode,
    MeasurementGraph,
    SurfaceModel,
)
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax import tangent as TT
from opencalibration_tpu_torch.relax.tracks import build_multiray_tracks as t_tracks
from opencalibration_tpu_torch.types import graph as TG
from tests.test_torch_ground_plane import BROWN, _assert_same_problem, _jcam, _solve
from tests.test_tracks import make_tracked_graph
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DOWN = np.asarray([0.0, 1.0, 0.0, 0.0])
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.array(x))


def _grid_mesh(rng, n=4, lo=(-40.0, -40.0), hi=(70.0, 60.0), z_scale=1.5):
    """An n x n vertex grid mesh over [lo, hi] with random heights."""
    xs, ys = np.meshgrid(np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n))
    verts = np.column_stack([xs.ravel(), ys.ravel(), rng.normal(scale=z_scale, size=n * n)])
    tris = []
    for r in range(n - 1):
        for c in range(n - 1):
            a, b, d, e = r * n + c, r * n + c + 1, (r + 1) * n + c, (r + 1) * n + c + 1
            tris += [[a, b, e], [a, e, d]]
    return TriMesh(verts, np.asarray(tris, np.int32))


# ---------------------------------------------------------------------------
# Mesh-prior block families
# ---------------------------------------------------------------------------


def _prior_blocks(mesh, V):
    """(JAX blocks, port blocks) of the three priors, anchored 0.25 m above
    the mesh."""
    jl, tl = JT.TangentLayout(2, V, 0, 1), TT.TangentLayout(2, V, 0, 1)
    e = mesh.all_edges()
    interior, opposite, _ = mesh.interior_edges()
    v = mesh.vertices
    nv = mesh.num_vertices
    j_blocks = [
        JB.mesh_flat_block(jl, e[:, 0].astype(np.int32), e[:, 1].astype(np.int32), np.ones(len(e))),
        JB.mesh_anchor_block(jl, np.arange(nv, dtype=np.int32), v[:, 2] + 0.25, np.ones(nv)),
        JB.mesh_smooth_block(jl, *(a.astype(np.int32) for a in (interior[:, 0], interior[:, 1], opposite[:, 0],
                                                                  opposite[:, 1])),
                             v[interior[:, 0], :2], v[interior[:, 1], :2], v[opposite[:, 0], :2],
                             v[opposite[:, 1], :2], np.ones(len(interior))),
    ]
    t_blocks = [
        TB.mesh_flat_block(tl, _t(e[:, 0]).long(), _t(e[:, 1]).long(), torch.ones(len(e), dtype=F64)),
        TB.mesh_anchor_block(tl, torch.arange(nv), _t(v[:, 2] + 0.25), torch.ones(nv, dtype=F64)),
        TB.mesh_smooth_block(tl, *(_t(a).long() for a in (interior[:, 0], interior[:, 1], opposite[:, 0],
                                                         opposite[:, 1])),
                             _t(v[interior[:, 0], :2]), _t(v[interior[:, 1], :2]), _t(v[opposite[:, 0], :2]),
                             _t(v[opposite[:, 1], :2]), torch.ones(len(interior), dtype=F64)),
    ]
    return j_blocks, t_blocks


@pytest.mark.parametrize("family", [0, 1, 2], ids=["mesh_flat", "mesh_anchor", "mesh_smooth"])
@pytest.mark.parametrize("relief", ["rough", "coplanar"])
def test_mesh_prior_residuals_and_jacobians(family, relief):
    rng = np.random.default_rng(4)
    mesh = _grid_mesh(rng, z_scale=1.5 if relief == "rough" else 0.0)
    V = 32
    j_blocks, t_blocks = _prior_blocks(mesh, V)
    jb, tb = j_blocks[family], t_blocks[family]
    assert jb.name == tb.name and jb.num_residuals == tb.num_residuals == 1
    np.testing.assert_array_equal(tb.slots.numpy(), np.asarray(jb.slots))
    mesh_z = np.zeros(V)
    mesh_z[: mesh.num_vertices] = mesh.vertices[:, 2]
    quats = np.tile(DOWN, (2, 1))
    jp = JT.RelaxParams.create(jnp.asarray(quats), jnp.zeros((2, 3)), mesh_z=jnp.asarray(mesh_z), dtype=jnp.float64)
    tp = TT.RelaxParams.create(_t(quats), torch.zeros(2, 3, dtype=F64), mesh_z=_t(mesh_z), dtype=F64)
    L = jb.slots.shape[1]
    j_data = {k: jnp.asarray(v) for k, v in jb.data.items()}
    ref_r = np.asarray(jax.vmap(lambda d: jb.resid_one(jnp.zeros(L), d, jp))(j_data))
    ref_J = np.asarray(jax.vmap(lambda d: jax.jacfwd(lambda dl: jb.resid_one(dl, d, jp))(jnp.zeros(L)))(j_data))
    z = torch.zeros(L, dtype=F64)
    got_r = torch.func.vmap(lambda d: tb.resid_one(z, d, tp))(tb.data).numpy()
    got_J = torch.func.vmap(lambda d: torch.func.jacfwd(lambda dl: tb.resid_one(dl, d, tp))(z))(tb.data).numpy()
    assert np.isfinite(ref_r).all() and np.isfinite(ref_J).all()
    np.testing.assert_allclose(got_r, ref_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_J, ref_J, rtol=0, atol=1e-9)
    if relief == "coplanar" and jb.name == "mesh_smooth":
        # the side correction: coplanar neighbours measure 0, not pi
        np.testing.assert_allclose(got_r, 0.0, atol=1e-9)


# ---------------------------------------------------------------------------
# Multi-ray tracks
# ---------------------------------------------------------------------------


def _assert_same_tracks(got, ref):
    (g_rows, g_used, g_cov), (r_rows, r_used, r_cov) = got, ref
    assert g_used == r_used and g_cov == r_cov
    assert set(g_rows) == set(r_rows)
    for k, v in r_rows.items():
        if k == "fixed_dir":
            np.testing.assert_allclose(g_rows[k], v, rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(g_rows[k], v, err_msg=k)


@pytest.mark.parametrize("edges", ["all", "two_view_only"])
def test_multiray_tracks_on_the_reference_fixture(edges):
    graph, ids, edge_ids, model, positions = make_tracked_graph()
    if edges == "two_view_only":
        edge_ids = edge_ids[:1]
    cam_index = {nid: i for i, nid in enumerate(ids)}
    node_model = {nid: 1 for nid in ids}
    mesh = TriMesh(np.array([[-50.0, -50, 0], [80.0, -50, 0], [10.0, 80, 0]]), np.array([[0, 1, 2]], np.int32))
    quats = np.tile(DOWN, (3, 1))
    ref = j_tracks(graph, cam_index, node_model, {1: model}, quats, positions, mesh, edge_ids, 0.15)
    got = t_tracks(interop.graph_from(graph), cam_index, node_model, {1: interop.camera_from(model, "cpu")}, quats,
                   positions, interop.mesh_from(mesh), edge_ids, 0.15, device="cpu")
    _assert_same_tracks(got, ref)
    assert bool(got[0]) == (edges == "all")


def _tracked_graph(seed=5):
    """A 2 x 3 nadir survey over 1.5 m of relief as the link stage leaves it,
    with features: each image's features are the projections of the ground
    points it sees (0.2 px noise), in a shuffled order, and each edge to the
    3 nearest neighbours carries the points both images see as inliers, so
    features chain into multi-image tracks. All orientations are finite
    (0.04 rad from nadir). Returns (graph, ids, JAX model store)."""
    rng = np.random.default_rng(seed)
    model = _jcam(**BROWN)
    graph = MeasurementGraph(seed=0)
    n_pts = 1500
    ground = np.column_stack([rng.uniform(-25, 50, n_pts), rng.uniform(-20, 40, n_pts), np.zeros(n_pts)])
    ground[:, 2] = 1.5 * np.sin(ground[:, 0] / 9.0) * np.cos(ground[:, 1] / 11.0)
    pos, ids, feat_of, xys = [], [], [], []
    for r in range(2):
        for c in range(3):
            p = np.asarray([12.0 * c, 12.0 * r, 60.0 + 10.0 * r])
            q = np.asarray(JQ.quat_boxplus(DOWN, rng.normal(scale=0.04, size=3)))
            px = np.asarray(JD.image_from_3d_world(ground, model, p, q))
            seen = np.flatnonzero((px[:, 0] > 2) & (px[:, 0] < 318) & (px[:, 1] > 2) & (px[:, 1] < 238))
            order = rng.permutation(seen)
            xy = (px[order] + rng.normal(scale=0.2, size=(len(order), 2))).astype(np.float32)
            node = ImageNode(path=f"IMG_{3 * r + c}", model_id=1, position=p, orientation=q)
            node.features = FeatureSet(xy=xy, strength=np.ones(len(xy), np.float32),
                                       descriptors=np.zeros((len(xy), 16), np.uint32), valid=np.ones(len(xy), bool))
            ids.append(graph.add_node(node))
            pos.append(p)
            feat_of.append({int(pt): k for k, pt in enumerate(order)})
            xys.append(xy)
    pos = np.asarray(pos)
    for i in range(6):
        d2 = np.sum((pos[:, :2] - pos[i, :2]) ** 2, axis=1)
        for j in np.argsort(d2)[1:4]:
            if graph.get_edge_id(ids[j], ids[i]) is not None:
                continue
            common = sorted(set(feat_of[i]) & set(feat_of[j]))[:250]
            i1 = np.asarray([feat_of[i][pt] for pt in common], np.int32)
            i2 = np.asarray([feat_of[j][pt] for pt in common], np.int32)
            n = len(common)
            rel = CameraRelations()
            rel.inlier_idx1, rel.inlier_idx2 = i1, i2
            rel.inlier_pixel1 = xys[i][i1].astype(np.float64)
            rel.inlier_pixel2 = xys[j][i2].astype(np.float64)
            rel.match_distance = rng.uniform(0.0, 0.3, n).astype(np.float32)
            rel.inlier_match_index = np.arange(n, dtype=np.int32)
            rel.ransac_relation = np.asarray([[1.0, 0.01, 3.0], [-0.01, 1.0, -2.0], [0.0, 0.0, 1.0]])
            graph.add_edge(rel, ids[i], ids[j])
    return graph, ids, {1: model}


def _poses(graph, ids, types=JG):
    """The second row as the group, the first as its frozen boundary, as
    ``types.NodePose``s."""
    return [types.NodePose(node_id=i, orientation=np.asarray(graph.get_node(i).payload.orientation).copy(),
                           position=np.asarray(graph.get_node(i).payload.position).copy()) for i in ids[3:]]


@pytest.fixture(scope="module")
def tracked():
    graph, ids, j_models = _tracked_graph()
    t_models = {mid: interop.camera_from(m, "cpu") for mid, m in j_models.items()}
    return graph, interop.graph_from(graph), ids, j_models, t_models


def test_multiray_tracks_on_a_survey(tracked):
    graph, t_graph, ids, j_models, t_models = tracked
    cam_index = {nid: i for i, nid in enumerate(ids)}
    node_model = {nid: 1 for nid in ids}
    quats = np.stack([graph.get_node(i).payload.orientation for i in ids])
    positions = np.stack([graph.get_node(i).payload.position for i in ids])
    mesh = _grid_mesh(np.random.default_rng(6), z_scale=0.5)
    edge_ids = sorted(graph.edge_ids())
    ref = j_tracks(graph, cam_index, node_model, j_models, quats, positions, mesh, edge_ids, 0.1)
    got = t_tracks(t_graph, cam_index, node_model, t_models, quats, positions, interop.mesh_from(mesh), edge_ids, 0.1,
                   device="cpu")
    _assert_same_tracks(got, ref)
    rows = ref[0]
    # tracks of 3 to 5 rays, some of them longer than 3
    n_rays = rows["ray_valid"].sum(axis=1)
    assert len(n_rays) > 20 and n_rays.min() >= 3 and n_rays.max() > 3


# ---------------------------------------------------------------------------
# The ground-mesh problem builder and refresh_problem
# ---------------------------------------------------------------------------


def _previous(case):
    """The previous surfaces a ground-mesh build starts from."""
    if case == "refined_mesh":
        rng = np.random.default_rng(7)
        cloud = np.column_stack([rng.uniform(-10, 40, 50), rng.uniform(-10, 30, 50), rng.normal(size=50)])
        return [SurfaceModel(cloud=[cloud], mesh=_grid_mesh(rng, z_scale=0.8))]
    return []  # the minimal mesh under the cameras


def _same_built(got, ref):
    _assert_same_problem(got, ref)
    assert (got.kind, got.num_opt, got.v_real) == (ref.kind, ref.num_opt, ref.v_real)
    np.testing.assert_allclose(got.mesh.vertices, ref.mesh.vertices, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.mesh.triangles, ref.mesh.triangles)


@pytest.mark.parametrize("case", ["refined_mesh", "minimal_mesh"])
def test_ground_mesh_problem_refresh_and_solve(tracked, case):
    graph, t_graph, ids, j_models, t_models = tracked
    edge_ids = sorted(graph.edge_ids())
    opts_j = JPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1)
    opts_t = TPB.RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=0.1)
    prev = _previous(case)
    ref = JPB.build_mesh_problem(graph, _poses(graph, ids), j_models, edge_ids, opts_j, prev, 0.1)
    got = TPB.build_mesh_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids, opts_t,
                                 [interop.surface_from(sm) for sm in prev], 0.1, dtype=F64, device="cpu")
    _same_built(got, ref)
    names = [b.name for b in ref.blocks]
    assert names[:2] == ["plane_ray", "downwards_prior"] and "mesh_anchor" in names
    assert (np.asarray(ref.blocks[0].data["ray_valid"]).sum(axis=1) > 2).any()  # track rows are in

    # the next pass: moved poses, the solved mesh's heights, re-anchored priors
    rng = np.random.default_rng(8)
    poses = _poses(graph, ids)
    for p in poses:
        p.orientation = np.asarray(JQ.quat_boxplus(p.orientation, rng.normal(scale=0.01, size=3)))
    moved = ref.mesh.copy()
    moved.vertices[:, 2] += rng.normal(scale=0.3, size=moved.num_vertices)
    surfaces = [SurfaceModel(cloud=[], mesh=moved)]
    t_poses = [TG.NodePose(p.node_id, p.orientation.copy(), p.position.copy()) for p in poses]
    assert JPB.refresh_problem(ref, graph, poses, j_models, surfaces, opts_j)
    assert TPB.refresh_problem(got, t_graph, t_poses, t_models, [interop.surface_from(sm) for sm in surfaces], opts_t)
    _same_built(got, ref)
    anchor = next(b for b in got.blocks if b.name == "mesh_anchor")
    np.testing.assert_allclose(anchor.data["target"].numpy(), moved.vertices[:, 2], rtol=0, atol=1e-12)

    # a refined mesh no longer fits the cached structure
    other = _grid_mesh(rng, n=5)
    other = SurfaceModel(cloud=[], mesh=other)
    assert not JPB.refresh_problem(ref, graph, poses, j_models, [other], opts_j)
    assert not TPB.refresh_problem(got, t_graph, t_poses, t_models, [interop.surface_from(other)], opts_t)

    # and the refreshed problem solves alike
    ref_poses, got_poses = _poses(graph, ids), _poses(t_graph, ids, TG)
    ref_surf = JPB.solve_problem(ref, ref_poses, dict(j_models), pre_solve_surface=True)
    got_surf = _solve(got, got_poses, pre_solve=True)
    for r, g in zip(ref_poses, got_poses):
        np.testing.assert_allclose(g.orientation, r.orientation, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_surf.mesh.vertices, ref_surf.mesh.vertices, rtol=0, atol=1e-6)
