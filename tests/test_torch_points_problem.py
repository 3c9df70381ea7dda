"""The port's 3-d point relax problem (``problem_builder.build_points_problem``,
``relax.build_problem`` with ``points_3d``) against the JAX package's, in
float64 on the CPU.

Cases: the three-camera, five-point tracked graph of tests/test_points_problem.py
(orientations perturbed by 0.03-0.04 rad) and the 2 x 3 relief survey with two
camera models of tests/test_torch_camera_relax.py. Tolerances: the built
problem equal in structure, float leaves and data within 1e-9 (the
triangulated points come from each package's own undistortion); the relax
(the reference's ``relax``, the port's build, batched solve and write-back)
within 1e-8 rad, 1e-8 m and 1e-8 px of the reference, the focal-free variant's
forward models within 1e-7 relative; orientations recovered within 1e-3 rad
and points within 0.1 m of the ground, as the reference's own test asks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax.relax import relax as j_relax
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import group_solver as TGS
from opencalibration_tpu_torch.relax import problem_builder as TPB
from opencalibration_tpu_torch.relax import relax as TR
from opencalibration_tpu_torch.types import graph as TG
from tests.test_torch_camera_relax import tracked  # noqa: F401 (fixture)
from tests.test_torch_ground_mesh import _poses
from tests.test_tracks import DOWN, make_tracked_graph
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
BUILD_TOL = dict(rtol=1e-9, atol=1e-9)
SOLVE_TOL = 1e-8
MODEL_REL = 1e-7


def _assert_same_built(got, ref):
    """Structure, masks, slots and integer data equal; float leaves and data
    within BUILD_TOL."""
    assert got.cam_index == ref.cam_index and got.model_index == ref.model_index
    assert (got.layout.C, got.layout.V, got.layout.P, got.layout.M) == \
        (ref.layout.C, ref.layout.V, ref.layout.P, ref.layout.M)
    assert (got.kind, got.num_opt, got.inverse_models) == (ref.kind, ref.num_opt, ref.inverse_models)
    np.testing.assert_array_equal(got.free_mask.numpy(), np.asarray(ref.free_mask))
    np.testing.assert_array_equal(got.surface_free_mask.numpy(), np.asarray(ref.surface_free_mask))
    for f, v in interop.relax_params_to_numpy(got.params).items():
        np.testing.assert_allclose(v, np.asarray(getattr(ref.params, f)), err_msg=f, **BUILD_TOL)
    assert [b.name for b in got.blocks] == [b.name for b in ref.blocks]
    for gb, rb in zip(got.blocks, ref.blocks):
        np.testing.assert_array_equal(gb.slots.numpy(), np.asarray(rb.slots))
        np.testing.assert_array_equal(gb.weight.numpy(), np.asarray(rb.weight))
        assert set(gb.data) == set(rb.data)
        for k, v in gb.data.items():
            want = np.asarray(rb.data[k])
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{rb.name}.{k}")
            else:
                np.testing.assert_allclose(v.numpy(), want, err_msg=f"{rb.name}.{k}", **BUILD_TOL)


def _perturbed_poses(types, ids, positions):
    axes_angles = (([0.0, 1, 0], 0.03), ([0.0, 0, 1], -0.04), ([1.0, 0, 0], 0.03))
    poses = []
    for i, nid in enumerate(ids):
        noise = JQ.quat_from_axis_angle(jnp.asarray(axes_angles[i][0]), jnp.asarray(axes_angles[i][1]))
        q = np.asarray(JQ.quat_multiply(jnp.asarray(DOWN), noise))
        poses.append(types.NodePose(node_id=nid, orientation=q, position=positions[i].copy()))
    return poses


def _port_relax(graph, poses, models, edge_ids, options):
    """The port's relax of one working set: build, solve as a batch of one
    group, write back."""
    built, pre_solve = TR.build_problem(graph, poses, models, edge_ids, options, dtype=F64, device="cpu")
    batch = TGS.build_group_batch([built])
    solved, _ = TGS.solve_group_batch(batch, pre_solve)
    params = TGS.extract_group_params(batch, TGS.fetch_solved(solved), 0)
    return built, TPB.apply_solution(built, params, poses, models)


@pytest.mark.parametrize("focal", [False, True], ids=["poses", "focal"])
def test_points_relax_matches_reference_and_recovers(focal):
    graph, ids, edge_ids, model, positions = make_tracked_graph()
    opts_j = JPB.RelaxOptions(orientation=True, points_3d=True, focal=focal)
    opts_t = interop.relax_options_from(opts_j)
    j_poses, t_poses = _perturbed_poses(JG, ids, positions), _perturbed_poses(TG, ids, positions)
    j_models, t_models = {1: model}, {1: interop.camera_from(model, "cpu")}
    ref_built = JPB.build_points_problem(graph, j_poses, j_models, edge_ids, opts_j)
    built, surface = _port_relax(interop.graph_from(graph), t_poses, t_models, edge_ids, opts_t)
    _assert_same_built(built, ref_built)
    assert built.kind == "points" and built.layout.P == 15 and built.blocks[0].name == "pixel_error"
    assert [b.name for b in built.blocks][-1] == ("monotonicity" if focal else "pixel_error")

    ref_surface = j_relax(graph, j_poses, j_models, edge_ids, opts_j)
    for jp, tp in zip(j_poses, t_poses):
        np.testing.assert_allclose(tp.orientation, np.asarray(jp.orientation), rtol=0, atol=SOLVE_TOL)
    assert len(surface.cloud) == len(ref_surface.cloud) == 1 and surface.mesh is None
    np.testing.assert_allclose(surface.cloud[0], ref_surface.cloud[0], rtol=0, atol=SOLVE_TOL)
    for k in ("focal_length_pixels", "principal_point", "radial_distortion", "tangential_distortion"):
        np.testing.assert_allclose(interop.to_numpy(getattr(t_models[1], k)), np.asarray(getattr(j_models[1], k)),
                                   rtol=MODEL_REL, atol=1e-12, err_msg=k)
    errs = [float(JQ.quat_angle(JQ.quat_multiply(JQ.quat_conjugate(jnp.asarray(DOWN)), jnp.asarray(p.orientation))))
            for p in t_poses]
    if not focal:
        assert max(errs) < 1e-3, errs
        np.testing.assert_allclose(surface.cloud[0][:, 2], 0.0, atol=0.1)


@pytest.mark.parametrize("intrinsics", [False, True], ids=["poses", "radial"])
def test_build_points_problem_on_two_models_matches_reference(tracked, intrinsics):  # noqa: F811
    graph, t_graph, ids, j_models, t_models = tracked
    edge_ids = sorted(graph.edge_ids())
    extra = dict(focal=True, radial_tier=2) if intrinsics else {}
    opts_j = JPB.RelaxOptions(orientation=True, points_3d=True, **extra)
    ref = JPB.build_points_problem(graph, _poses(graph, ids), j_models, edge_ids, opts_j)
    got = TPB.build_points_problem(t_graph, _poses(t_graph, ids, TG), t_models, edge_ids,
                                   interop.relax_options_from(opts_j), dtype=F64, device="cpu")
    _assert_same_built(got, ref)
    np.testing.assert_allclose(got.track_points, ref.track_points, **BUILD_TOL)
    assert got.model_index == {1: 0, 2: 1} and got.layout.P > 20
    # a refresh of the cached structure keeps it and rebuilds the masks
    assert TPB.refresh_problem(got, t_graph, _poses(t_graph, ids, TG), t_models, [],
                               interop.relax_options_from(JPB.RelaxOptions(orientation=False, points_3d=True)))
    assert not got.free_mask[: 3 * got.layout.C].any() and got.free_mask[got.layout.point_off:got.layout.focal_off].all()


def test_points_relax_of_an_empty_graph_builds_nothing():
    built, pre_solve = TR.build_problem(TG.MeasurementGraph(), [], {}, [],
                                        TPB.RelaxOptions(points_3d=True), dtype=F64, device="cpu")
    assert built is None and pre_solve
