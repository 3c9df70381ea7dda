"""The port's CAMERA_PARAMETER_RELAX state with SEVERAL intrinsics groups
against the JAX ``Pipeline``, pass for pass: the entry state, the schedule
and the tolerances of tests/test_torch_pipeline_intrinsics.py on the 2 x 3
survey, with the intrinsics group size set to 3 on both sides. The 6 images
split into two groups, which the joint solver couples through the shared
camera model and surface (``group_solver.solve_group_batch_shared``; the JAX
side spreads the groups over its virtual CPU devices).

Each group here is one image row at one altitude, which leaves focal and
height a null direction inside a group, and the survey has only two rows:
the focal drifts up its valley (420 -> 458 px) on BOTH sides alike. What is
held here is the parity with the reference; the focal's recovery is held on
the 3 x 3 survey in tests/test_torch_pipeline_intrinsics.py.
"""

import numpy as np
import pytest

from tests.test_torch_pipeline_intrinsics import (
    RELAX_MAX_ITERATIONS,
    TAG_FOCAL,
    _assert_passes_match,
    _both,
    _edge_inliers,
    _entry_state,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP_SIZE = 3


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    return _both(_entry_state(str(tmp_path_factory.mktemp("multigroup_survey")), 2, 3), GROUP_SIZE)


def test_multigroup_run_matches_reference(multi):
    """Intrinsics groups of 3: two groups, coupled through the shared camera
    model and surface by the joint solver, pass for pass as the reference's,
    then the same edges refitted to the same inlier sets."""
    ref, got = multi
    assert got.groups == ref.groups and min(got.groups) > 1
    _assert_passes_match(got.log, ref.log)
    assert (got.builds, got.refreshes) == (ref.builds, ref.refreshes)
    assert got.builds == got.groups[0] and got.refreshes == RELAX_MAX_ITERATIONS * got.groups[0]
    want, have = _edge_inliers(ref.pipeline), _edge_inliers(got.pipeline)
    for k in want:
        np.testing.assert_array_equal(have[k].inlier_match_index, want[k].inlier_match_index, err_msg=str(k))
    focal = got.log[-1]["focal"]
    print(f"multi-group focal {focal:.3f} (tag {TAG_FOCAL})")
    assert focal != TAG_FOCAL and np.isfinite(focal)
    assert got.pipeline.graph.size_nodes() == 6
    assert all(np.isfinite(n.payload.orientation).all() for _, n in got.pipeline.graph.nodes())


def test_multigroup_groups_own_their_writes(multi):
    """Each cross-group edge is taken by its source's group, whose far end
    joins as a co-optimised duplicate; every image is written by exactly one
    group."""
    _, got = multi
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions

    p = got.pipeline
    size = ST.INTRINSICS_GROUP_SIZE
    ST.INTRINSICS_GROUP_SIZE = GROUP_SIZE
    try:
        stage = ST.RelaxStage(device="cpu")
        stage.init(p.graph, [], p.gps_positions, p.model_store, relax_all=True, disable_parallelism=False,
                   options=RelaxOptions(orientation=True, ground_mesh=True, focal=True))
    finally:
        ST.INTRINSICS_GROUP_SIZE = size
    groups = stage._groups
    assert len(groups) == got.groups[0]
    written = [nid for g in groups for nid in g.write_ids]
    assert sorted(written) == sorted(p.graph.node_ids())  # a partition of the images
    owned = [eid for g in groups for eid in g.edge_ids]
    assert len(owned) == len(set(owned))  # no edge counted twice in the joint objective
    for g in groups:
        local = {pose.node_id for pose in g.poses}
        assert g.write_ids < local  # halo duplicates ride along
        assert sorted(g.cam_models) == sorted(p.model_store)  # every group lists the whole store
        for eid in g.edge_ids:
            e = p.graph.get_edge(eid)
            assert e.source in local and e.dest in local
            assert e.source in g.write_ids or e.dest in g.write_ids
