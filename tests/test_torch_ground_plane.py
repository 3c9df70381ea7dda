"""Parity of the port's ground-plane relax (model inversion, ray geometry, the
plane-ray block family, the decomposition and ground-plane problem builders
and their solves) with the JAX package, in float64.

Tolerances: model conversions, ray geometry, robust centroids, plane-ray
residuals and per-instance Jacobians within 1e-9 (NaN where the reference
gives NaN); built problems equal (block arrays, slots, free masks, measured
rows); solved orientations and plane heights within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import distort as JD
from opencalibration_tpu.ops import intersection as JI
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.relax import blocks as JB
from opencalibration_tpu.relax import lm as JLM
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax import tangent as JT
from opencalibration_tpu.types.camera import CameraModel as JCamera
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.graph import CameraRelations, ImageNode, MeasurementGraph
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops import distort as TD
from opencalibration_tpu_torch.ops import intersection as TI
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.relax import blocks as TB
from opencalibration_tpu_torch.relax import lm as TLM
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax import relax as TR
from opencalibration_tpu_torch.relax import tangent as TT
from opencalibration_tpu_torch.types import graph as TG
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DOWN = np.asarray([0.0, 1.0, 0.0, 0.0])
F64 = torch.float64
BROWN = dict(radial_distortion=(-0.08, 0.02, -0.004), tangential_distortion=(8e-4, -5e-4))


def _jcam(**distortion):
    return JCamera.create(400.0, (163.0, 118.0), pixels_cols=320.0, pixels_rows=240.0,
                          dtype=jnp.float64, **distortion)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("distortion", [BROWN, {}], ids=["brown", "none"])
def test_model_conversions(distortion):
    jm = _jcam(**distortion)
    j_inv = JD.convert_to_inverse(jm)
    t_inv = TD.convert_to_inverse(interop.camera_from(jm, "cpu"))
    j_fwd = JD.convert_to_forward(j_inv)
    t_fwd = TD.convert_to_forward(interop.camera_from(j_inv, "cpu"))
    for ref, got in ((j_inv, t_inv), (j_fwd, t_fwd)):
        assert got.tag == ref.tag
        for k, v in interop.camera_to_numpy(got).items():
            if k != "tag":
                np.testing.assert_allclose(v, np.asarray(getattr(ref, k)), rtol=0, atol=1e-9, err_msg=k)
    with pytest.raises(ValueError):
        TD.convert_to_forward(interop.camera_from(jm, "cpu"))


def test_ray_geometry():
    rng = np.random.default_rng(0)
    n = 64
    d1, d2 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    o1, o2 = rng.normal(size=(n, 3)) * 5, rng.normal(size=(n, 3)) * 5
    d2[:4] = d1[:4] * 2.0  # parallel rays: NaN
    ref = JI.ray_intersection(d1, o1, d2, o2)
    got = TI.ray_intersection(_t(d1), _t(o1), _t(d2), _t(o2))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-9)
    errs = got[1].numpy()
    assert np.isnan(errs[:4]).all() and (errs[4:] < 0).any() and (errs[4:] > 0).any()

    corners = rng.normal(size=(n, 3, 3)) * 10
    rn, ro = JI.corner_plane_to_norm_offset(corners)
    gn, go = TI.corner_plane_to_norm_offset(_t(corners))
    np.testing.assert_allclose(gn.numpy(), np.asarray(rn), rtol=0, atol=1e-12)
    np.testing.assert_allclose(go.numpy(), np.asarray(ro), rtol=0, atol=0)
    d1[:3] = np.cross(np.asarray(rn[:3]), rng.normal(size=(3, 3)))  # in the plane: no hit
    ref_p, ref_hit = JI.ray_plane_intersection(d1, o1, rn, ro)
    got_p, got_hit = TI.ray_plane_intersection(_t(d1), _t(o1), gn, go)
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(ref_hit))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=0, atol=1e-9)
    assert not got_hit[:3].any()


@pytest.mark.parametrize("case", ["spread", "outlier", "one_valid"])
def test_robust_centroid(case):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(5, 3))
    valid = np.asarray([True, True, True, False, True])
    if case == "outlier":
        pts[4] += 40.0
    if case == "one_valid":
        valid = np.asarray([False, False, True, False, False])
    pts[3] = np.nan  # masked-out payload must not poison the sums
    for huber in (0.01, 0.5, 100.0):
        ref = JB.robust_centroid(jnp.asarray(pts), jnp.asarray(valid), huber)
        got = TB.robust_centroid(_t(pts), _t(valid), torch.tensor(huber, dtype=F64))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


def _plane_ray_inputs(rng, form, inv_model, B=24):
    """A tilted triangle under 4 cameras and B instances of 2 to 5 valid rays.
    The last instance's first ray lies in the plane of its own triangle
    (vertices 3-5): a parallel valid ray, for which the reference gives NaN."""
    C, V = 4, 8
    quats = np.stack([np.asarray(JQ.quat_boxplus(DOWN, rng.normal(scale=0.05, size=3))) for _ in range(C)])
    positions = np.column_stack([rng.uniform(0, 30, C), rng.uniform(0, 30, C), rng.uniform(55, 85, C)])
    mesh_z = rng.normal(scale=0.5, size=V)
    tri_xy = np.tile(np.asarray([[-60.0, -60.0], [90.0, -60.0], [15.0, 90.0]]), (B, 1, 1))
    vert_idx = np.tile(np.asarray([0, 1, 2]), (B, 1))
    cam_idx = rng.integers(0, C, size=(B, 5))
    cam_idx[:, 1] = (cam_idx[:, 0] + 1) % C
    ray_valid = np.arange(5)[None] < rng.integers(2, 6, size=(B, 1))
    fixed_dir = rng.normal(scale=0.3, size=(B, 5, 3))
    fixed_dir[..., 2] = 1.0
    fixed_dir /= np.linalg.norm(fixed_dir, axis=-1, keepdims=True)
    pixel = rng.uniform([0, 0], [320, 240], size=(B, 5, 2))
    # plane z = a x through vertices 3-5 containing the world ray w
    cam_dir = fixed_dir[-1, 0] if form == "fixed_dir" else np.asarray(JD.image_to_3d(pixel[-1, 0], inv_model))
    w = np.asarray(JQ.quat_rotate(quats[cam_idx[-1, 0]], cam_dir))
    vert_idx[-1] = [3, 4, 5]
    tri_xy[-1] = [[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]]
    mesh_z[3:6] = w[2] / w[0] * np.asarray([0.0, 10.0, 0.0])
    return dict(quats=quats, positions=positions, mesh_z=mesh_z, vert_idx=vert_idx, tri_xy=tri_xy,
                cam_idx=cam_idx, ray_valid=ray_valid, fixed_dir=fixed_dir, pixel=pixel, C=C, V=V, B=B)


@pytest.mark.parametrize("form", ["fixed_dir", "pixel"])
def test_plane_ray_block_residuals_and_jacobians(form):
    rng = np.random.default_rng(2)
    inv = JD.convert_to_inverse(_jcam(**BROWN))
    x = _plane_ray_inputs(rng, form, inv)
    kw = dict(focal=np.asarray([400.0]), principal=np.asarray([[163.0, 118.0]]),
              radial=np.asarray(inv.radial_distortion)[None], tangential=np.asarray(inv.tangential_distortion)[None])
    jl, tl = JT.TangentLayout(x["C"], x["V"], 0, 1), TT.TangentLayout(x["C"], x["V"], 0, 1)
    j_params = JT.RelaxParams.create(jnp.asarray(x["quats"]), x["positions"], mesh_z=x["mesh_z"],
                                     dtype=jnp.float64, **kw)
    t_params = TT.RelaxParams.create(_t(x["quats"]), _t(x["positions"]), mesh_z=_t(x["mesh_z"]), dtype=F64,
                                     **{k: _t(v) for k, v in kw.items()})
    form_kw = {form: x[form]}
    j_blk = JB.plane_ray_block(jl, x["vert_idx"].astype(np.int32), x["tri_xy"], x["cam_idx"].astype(np.int32),
                               x["ray_valid"], np.ones(x["B"]), **form_kw)
    t_blk = TB.plane_ray_block(tl, _t(x["vert_idx"]), _t(x["tri_xy"]), _t(x["cam_idx"]), _t(x["ray_valid"]),
                               torch.ones(x["B"], dtype=F64), **{form: _t(x[form])})
    np.testing.assert_array_equal(t_blk.slots.numpy(), np.asarray(j_blk.slots))
    assert t_blk.slots.shape[1] == 24 and t_blk.num_residuals == j_blk.num_residuals == 15

    def j_one(d):
        return jax.jacfwd(lambda dl: j_blk.resid_one(dl, d, j_params))(jnp.zeros(24))

    j_data = {k: jnp.asarray(v) for k, v in j_blk.data.items()}
    ref_r = np.asarray(jax.vmap(lambda d: j_blk.resid_one(jnp.zeros(24), d, j_params))(j_data))
    ref_J = np.asarray(jax.vmap(j_one)(j_data))
    z = torch.zeros(24, dtype=F64)
    got_r = torch.func.vmap(lambda d: t_blk.resid_one(z, d, t_params))(t_blk.data).numpy()
    got_J = torch.func.vmap(lambda d: torch.func.jacfwd(lambda dl: t_blk.resid_one(dl, d, t_params))(z))(
        t_blk.data).numpy()
    assert np.isnan(ref_r[-1]).all() and np.isfinite(ref_r[:-1]).all()
    np.testing.assert_allclose(got_r, ref_r, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_J, ref_J, rtol=0, atol=1e-9)

    # the LM zeroes the NaN instance alike: equal normal equations
    free = np.ones(jl.dim, bool)
    H_ref, g_ref = JLM.normal_equations(j_params, [j_blk], jl, free)
    H, g = TLM.normal_equations(t_params, [t_blk], tl, torch.from_numpy(free))
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# Problem builders on one graph made with the JAX package's containers
# ---------------------------------------------------------------------------


def _graph(distortion):
    """A 2 x 3 nadir survey over the plane z = 0 as the link stage leaves it:
    nodes with GPS positions (the first row already relaxed, the second new),
    edges to the 3 nearest neighbours carrying the projected inlier pixels
    (0.3 px noise), match distances, a homography and 4 scored relative
    poses. Returns (graph, node ids, JAX model store, true orientations)."""
    rng = np.random.default_rng(3)
    model = _jcam(**distortion)
    graph = MeasurementGraph(seed=0)
    pos, quats, ids = [], [], []
    for r in range(2):
        for c in range(3):
            p = np.asarray([12.0 * c, 12.0 * r, 60.0 + 20.0 * r])
            q = np.asarray(JQ.quat_boxplus(DOWN, rng.normal(scale=0.04, size=3)))
            node = ImageNode(path=f"IMG_{3 * r + c}", model_id=1, position=p,
                             orientation=q if r == 0 else np.full(4, np.nan))
            ids.append(graph.add_node(node))
            pos.append(p), quats.append(q)
    pos, quats = np.asarray(pos), np.asarray(quats)
    ground = np.column_stack([rng.uniform(-30, 55, 4000), rng.uniform(-30, 45, 4000), np.zeros(4000)])
    for i in range(6):
        d2 = np.sum((pos[:, :2] - pos[i, :2]) ** 2, axis=1)
        for j in np.argsort(d2)[1:4]:
            if graph.get_edge_id(ids[j], ids[i]) is not None:
                continue
            px = [np.asarray(JD.image_from_3d_world(ground, model, pos[k], quats[k])) for k in (i, j)]
            inside = np.all([(p[:, 0] > 0) & (p[:, 0] < 320) & (p[:, 1] > 0) & (p[:, 1] < 240) for p in px], axis=0)
            sel = np.flatnonzero(inside)[:150]
            n = len(sel)
            rel = CameraRelations()
            rel.inlier_idx1 = np.arange(n, dtype=np.int32)
            rel.inlier_idx2 = np.arange(n, dtype=np.int32)
            rel.inlier_pixel1 = px[0][sel] + rng.normal(scale=0.3, size=(n, 2))
            rel.inlier_pixel2 = px[1][sel] + rng.normal(scale=0.3, size=(n, 2))
            rel.match_distance = rng.uniform(0.0, 0.3, n).astype(np.float32)
            rel.inlier_match_index = np.arange(n, dtype=np.int32)
            rel.ransac_relation = np.asarray([[1.0, 0.01, 3.0], [-0.01, 1.0, -2.0], [0.0, 0.0, 1.0]])
            true_q = np.asarray(JQ.quat_multiply(quats[j], JQ.quat_conjugate(quats[i])))
            tdir = np.asarray(JQ.quat_rotate_inverse(quats[i], (pos[j] - pos[i]) / np.linalg.norm(pos[j] - pos[i])))
            rel.rel_quats = np.stack([np.asarray(JQ.quat_boxplus(true_q, rng.normal(scale=s, size=3)))
                                      for s in (0.01, 0.5, 0.5, 0.5)])
            rel.rel_positions = tdir[None] + rng.normal(scale=0.05, size=(4, 3))
            rel.rel_scores = np.asarray([90.0, 30.0, 10.0, 0.0])
            graph.add_edge(rel, ids[i], ids[j])
    return graph, ids, {1: model}, quats


def _poses(graph, ids, types=JG):
    """The second row as the group, the first as its frozen boundary, as
    ``types.NodePose``s."""
    return [types.NodePose(node_id=i, orientation=np.asarray(graph.get_node(i).payload.orientation).copy(),
                           position=np.asarray(graph.get_node(i).payload.position).copy()) for i in ids[3:]]


def _assert_same_problem(got, ref):
    assert got.cam_index == ref.cam_index and got.model_index == ref.model_index
    assert (got.layout.C, got.layout.V, got.layout.P, got.layout.M) == \
        (ref.layout.C, ref.layout.V, ref.layout.P, ref.layout.M)
    assert got.inverse_models == ref.inverse_models
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(ref.free_mask))
    np.testing.assert_array_equal(got.surface_free_mask.numpy(), np.asarray(ref.surface_free_mask))
    for f, v in interop.relax_params_to_numpy(got.params).items():
        np.testing.assert_allclose(v, np.asarray(getattr(ref.params, f)), rtol=0, atol=1e-9, err_msg=f)
    assert [b.name for b in got.blocks] == [b.name for b in ref.blocks]
    for gb, rb in zip(got.blocks, ref.blocks):
        assert gb.resid_one.__name__ == rb.resid_one.__name__ and gb.huber_delta == rb.huber_delta
        np.testing.assert_array_equal(gb.slots.numpy(), np.asarray(rb.slots))
        np.testing.assert_array_equal(gb.weight.numpy(), np.asarray(rb.weight))
        assert set(gb.data) == set(rb.data)
        for k, v in gb.data.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(rb.data[k]), rtol=0, atol=1e-9, err_msg=f"{rb.name}.{k}")
    np.testing.assert_allclose(got.track_points, ref.track_points, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.track_errors, ref.track_errors, rtol=0, atol=1e-9)


def _solve(built, poses, pre_solve):
    """The stage's solve of one group, then its write-back."""
    (params,), _ = TGS.solve_groups([built], pre_solve)
    return TPB.apply_solution(built, params, poses)


@pytest.mark.parametrize("distortion", [BROWN, {}], ids=["brown", "none"])
def test_ground_plane_problem_and_solve(distortion):
    graph, ids, j_models, truth = _graph(distortion)
    t_models = {mid: interop.camera_from(m, "cpu") for mid, m in j_models.items()}
    edge_ids = sorted(graph.edge_ids())
    opts_j = JPB.RelaxOptions(orientation=True, ground_plane=True)
    opts_t = TPB.RelaxOptions(orientation=True, ground_plane=True)
    ref = JPB.build_mesh_problem(graph, _poses(graph, ids), j_models, edge_ids, opts_j)
    t_graph = interop.graph_from(graph)
    got = TPB.build_mesh_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids, opts_t, dtype=F64, device="cpu")
    _assert_same_problem(got, ref)
    assert ref.blocks[0].name == "plane_ray" and ref.blocks[0].data["ray_valid"].sum() > 200
    np.testing.assert_array_equal(got.mesh.vertices, ref.mesh.vertices)

    ref_poses, got_poses = _poses(graph, ids), _poses(t_graph, ids, TG)
    ref_surf = JPB.solve_problem(ref, ref_poses, dict(j_models), pre_solve_surface=True)
    got_surf = _solve(got, got_poses, pre_solve=True)
    for r, g in zip(ref_poses, got_poses):
        np.testing.assert_allclose(g.orientation, r.orientation, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_surf.mesh.vertices, ref_surf.mesh.vertices, rtol=0, atol=1e-6)
    assert len(got_surf.cloud) == len(ref_surf.cloud)
    for g, r in zip(got_surf.cloud, ref_surf.cloud):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)
    # the relaxed second row sits near the truth its pixels were made from
    for p, q in zip(got_poses, truth[3:]):
        assert float(JQ.quat_angle(JQ.quat_multiply(p.orientation, JQ.quat_conjugate(q)))) < 0.02


def test_decomposition_problem_and_solve():
    graph, ids, _, _ = _graph({})
    edge_ids = sorted(graph.edge_ids())
    ref = JPB.build_decomposition_problem(graph, _poses(graph, ids), edge_ids)
    t_graph = interop.graph_from(graph)
    got = TPB.build_decomposition_problem(t_graph, _poses(t_graph, ids, TG), edge_ids, dtype=F64, device="cpu")
    _assert_same_problem(got, ref)
    ref_poses, got_poses = _poses(graph, ids), _poses(t_graph, ids, TG)
    JPB.solve_problem(ref, ref_poses)
    _solve(got, got_poses, pre_solve=False)
    for r, g in zip(ref_poses, got_poses):
        np.testing.assert_allclose(g.orientation, r.orientation, rtol=0, atol=1e-6)


def test_branches_not_ported_raise():
    """The branches that raised until they were ported now build: 3-d point
    problems (the points builder: tests/test_torch_points_problem.py holds it
    to the reference) and intrinsics in a ground-plane or ground-mesh
    problem, the pixel form of the plane-ray block with the monotonicity
    prior."""
    graph, ids, j_models, _ = _graph({})
    graph = interop.graph_from(graph)
    t_models = {mid: interop.camera_from(m, "cpu") for mid, m in j_models.items()}
    edge_ids = sorted(graph.edge_ids())
    built, pre_solve = TR.build_problem(graph, _poses(graph, ids, TG), t_models, edge_ids,
                                        TPB.RelaxOptions(points_3d=True), dtype=F64, device="cpu")
    assert pre_solve and built.kind == "points" and [b.name for b in built.blocks] == ["pixel_error"]
    # (the ground-mesh form needs image features for its tracks: tests/test_torch_camera_relax.py)
    built, pre_solve = TR.build_problem(graph, _poses(graph, ids, TG), t_models, edge_ids,
                                        TPB.RelaxOptions(ground_plane=True, focal=True), dtype=F64, device="cpu")
    assert pre_solve and "pixel" in built.blocks[0].data and built.blocks[-1].name == "monotonicity"
    assert bool(built.free_mask[built.layout.focal_off]) and not bool(built.surface_free_mask[built.layout.focal_off])
