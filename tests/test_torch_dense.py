"""Dense stereo and the intersection functions of the port
(opencalibration_tpu_torch/dense/dense_stereo.py, ops/intersection.py)
against the JAX package's, on the CPU.

``gated_match`` is held bit for bit (idx, best, good) on seeded descriptors
with ties, rows without candidates and rows with one. The intersection
functions are held in float64 within 1e-12 (1e-10 m for the iterated
two-pixel triangulation). ``densify_mesh`` runs from one
ground-truth entry state (the 2 x 3 colour survey at 320 x 240 at its true
poses over the flat mesh, as ``testing/ortho_cases.ground_truth_state``
builds it) in both packages: with the JAX package's dense feature sets
carried across, the same point count and the points within 1e-9 m in
float64; with each package's own re-extraction, the counts within 2 % and
the median distance from each port point to the nearest reference point
within 1e-3 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.dense import dense_stereo as JD
from opencalibration_tpu.ops import features as JF
from opencalibration_tpu.ops import intersection as JI
from opencalibration_tpu.surface.mesh import TriMesh as JTriMesh
from opencalibration_tpu.types import camera as JCamera
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.dense import dense_stereo as TD
from opencalibration_tpu_torch.ops import hamming as TH
from opencalibration_tpu_torch.ops import intersection as TI
from opencalibration_tpu_torch.testing import ortho_cases
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
GEOMETRY_TOL = dict(rtol=1e-12, atol=1e-12)
# the two-pixel triangulation's 20 LM steps end in steps of a few ulps, taken
# in each package's own summation order: 4e-12 m apart at 15 m
LM_TOL = dict(rtol=1e-12, atol=1e-10)
POINTS_M = 1e-9
OWN_COUNT_REL = 0.02
OWN_MEDIAN_M = 1e-3


# ---------------------------------------------------------------------------
# gated_match
# ---------------------------------------------------------------------------


def _match_case(seed, n1=300, n2=260):
    """Descriptors where set 1 holds noisy copies of set 2 and exact
    duplicates (ties), predictions that put some rows far from every
    candidate (empty gates) or near exactly one."""
    rng = np.random.default_rng(seed)
    bits2 = rng.integers(0, 2, (n2, TH.DESCRIPTOR_BITS)).astype(bool)
    bits2[1::7] = bits2[0::7][: len(bits2[1::7])]  # duplicate columns: ties for best
    src = rng.integers(0, n2, n1)
    bits1 = bits2[src] ^ (rng.random((n1, TH.DESCRIPTOR_BITS)) < rng.choice([0.02, 0.1, 0.3], n1)[:, None])
    xy2 = rng.uniform(0, 1000, (n2, 2)).astype(np.float32)
    pred = xy2[src] + rng.normal(0, 40, (n1, 2)).astype(np.float32)
    pred[::11] = 5000.0  # no candidate in the radius
    lone = np.arange(5, n1, 13)
    xy2[-1] = (-900.0, -900.0)
    pred[lone] = xy2[-1] + 1.0  # exactly one candidate
    valid1 = rng.random(n1) > 0.05
    valid2 = rng.random(n2) > 0.05
    valid2[-1] = True
    xy1 = rng.uniform(0, 1000, (n1, 2)).astype(np.float32)
    words1 = TH.pack_bits(torch.as_tensor(bits1)).numpy()
    words2 = TH.pack_bits(torch.as_tensor(bits2)).numpy()
    return words1, xy1, valid1, words2, xy2, valid2, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_match_bit_exact(seed):
    w1, xy1, v1, w2, xy2, v2, pred = _match_case(seed)
    j = JD._gated_match(jnp.asarray(w1.view(np.uint32)), jnp.asarray(xy1), jnp.asarray(v1),
                        jnp.asarray(w2.view(np.uint32)), jnp.asarray(xy2), jnp.asarray(v2), jnp.asarray(pred))
    t = TD.gated_match(*(torch.as_tensor(a) for a in (w1, xy1, v1, w2, xy2, v2, pred)))
    for name, got, want in zip(("idx", "best", "good"), t, j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    best = t[1].numpy()
    assert (best == 2.0).sum() > 0  # rows with an empty gate
    assert 0 < t[2].numpy().sum() < len(best)


def test_union_find_order():
    j, t = JD.UnionFind(9), TD.UnionFind(9)
    for a, b in [(3, 1), (5, 7), (7, 1), (8, 0), (2, 2), (6, 8)]:
        j.unite(a, b)
        t.unite(a, b)
    assert [t.find(i) for i in range(9)] == [j.find(i) for i in range(9)]
    assert t.parent == j.parent


# ---------------------------------------------------------------------------
# The intersection functions, float64
# ---------------------------------------------------------------------------


def _rays(rng, t, r):
    target = rng.normal(size=(t, 1, 3)) * 5
    origins = rng.normal(size=(t, r, 3)) * 20 + np.array([0, 0, 60])
    dirs = target - origins + rng.normal(size=(t, r, 3)) * 0.01
    valid = rng.random((t, r)) > 0.3
    valid[0] = [True] + [False] * (r - 1)  # one ray: no point
    return dirs, origins, valid


def _triangles(rng, n):
    corners = rng.normal(size=(n, 3, 3)) * 10
    origin = rng.normal(size=(n, 3)) * 3 + np.array([0, 0, 30])
    aim = corners.mean(axis=1) + rng.normal(size=(n, 3)) * 6
    return aim - origin, origin, corners


@pytest.mark.parametrize("fn", ["triangulate_tracks", "point_inside_triangle", "ray_triangle_intersection",
                                "ray_intersection_pixels"])
def test_intersection_functions_match_reference(fn):
    rng = np.random.default_rng(3)
    if fn == "triangulate_tracks":
        args = _rays(rng, 50, 8)
    elif fn == "point_inside_triangle":
        dirs, origin, corners = _triangles(rng, 200)
        args = (corners.mean(axis=1) + rng.normal(size=(200, 3)) * 4, corners)
    elif fn == "ray_triangle_intersection":
        args = _triangles(rng, 200)
    if fn != "ray_intersection_pixels":
        want = getattr(JI, fn)(*(jnp.asarray(a) for a in args))
        got = getattr(TI, fn)(*(torch.as_tensor(a) for a in args))
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), equal_nan=True, **GEOMETRY_TOL)
        return
    # two cameras of the survey looking at one ground point, pixels 0.5 px off
    positions, quats = TS.camera_grid(1, 2, spacing=15.0)
    jm = JCameraModel.create(400.0, (160.0, 120.0), (0.01, -0.002, 0.0), (0.0, 0.0), 320, 240, dtype=jnp.float64)
    tm = interop.camera_from(jm, "cpu")
    from opencalibration_tpu_torch.ops.distort import image_from_3d_world

    for point in ([5.0, 3.0, 0.5], [14.0, -6.0, -1.0]):
        px = [image_from_3d_world(torch.tensor(point, dtype=F64), tm, torch.as_tensor(positions[i], dtype=F64),
                                  torch.as_tensor(quats[i], dtype=F64)).numpy() + rng.normal(0, 0.5, 2)
              for i in (0, 1)]
        a = (positions[0], positions[1], quats[0], quats[1], px[0], px[1])
        wp, wc = JI.ray_intersection_pixels(jm, jm, *(jnp.asarray(x, jnp.float64) for x in a))
        tp, tc = TI.ray_intersection_pixels(tm, tm, *(torch.as_tensor(x, dtype=F64) for x in a))
        np.testing.assert_allclose(tp.numpy(), np.asarray(wp), **LM_TOL)
        np.testing.assert_allclose(float(tc), float(wc), rtol=1e-9, atol=1e-12)
        assert float(tc) < 1.0


# ---------------------------------------------------------------------------
# densify_mesh from one ground-truth state
# ---------------------------------------------------------------------------


def _take_camera_jnp(models, i):
    """The reference's ``take_camera`` on device-array leaves: its
    ``stack_cameras`` returns numpy leaves outside a trace, which its
    ``densify_mesh`` then indexes with a traced index inside ``vmap`` (a
    ``TracerArrayConversionError``; ROADMAP 3b)."""
    return jax.tree.map(lambda x: jnp.asarray(x)[i], models)


@pytest.fixture(scope="module")
def dense_state(tmp_path_factory):
    """The JAX side, run once: its graph (each node's features its dense
    set), camera models, mesh and dense sets (extracted with its float32
    blur, as the port has no bfloat16 one; tests/test_torch_features.py),
    and the points its ``densify_mesh`` appended."""
    d = str(tmp_path_factory.mktemp("dense_survey"))
    truth = ortho_cases.ground_truth_state(d)
    graph = JG.MeasurementGraph()
    for _, node in truth["graph"].nodes():
        graph.add_node(interop.image_node_from(node.payload, JG))
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    try:
        dense = JD.extract_dense_featuresets(graph, [nid for nid, _ in sorted(graph.nodes())])
    finally:
        JF.set_blur_precision(prior)
    for nid, node in graph.nodes():
        node.payload.features = dense[nid]
    models = {0: JCameraModel.create(TS.FOCAL, (TS.IMG_W / 2, TS.IMG_H / 2), pixels_cols=TS.IMG_W,
                                     pixels_rows=TS.IMG_H, dtype=jnp.float64)}
    mesh = interop.mesh_from(ortho_cases.flat_mesh(), JTriMesh)
    surfaces = [JG.SurfaceModel(cloud=[], mesh=mesh)]
    take = JCamera.take_camera
    JCamera.take_camera = _take_camera_jnp
    try:
        n = JD.densify_mesh(graph, models, surfaces, dense_features=dense)
    finally:
        JCamera.take_camera = take
    assert n == len(surfaces[0].cloud[-1])
    return graph, models, mesh, dense, surfaces[0].cloud[-1]


def _run_port(dense_state, carried):
    graph, models, mesh, dense, _ = dense_state
    surfaces = [interop.surface_from(JG.SurfaceModel(cloud=[], mesh=mesh))]
    t_dense = {nid: interop.feature_set_from(f) for nid, f in dense.items()} if carried else None
    stats = {}
    n = TD.densify_mesh(interop.graph_from(graph), interop.model_store_from(models), surfaces,
                        dense_features=t_dense, device="cpu", stats=stats)
    assert n == stats["points"] == len(surfaces[0].cloud[-1])
    return surfaces[0].cloud[-1], stats


def test_densify_mesh_with_carried_dense_sets_matches_reference(dense_state):
    ref = dense_state[-1]
    pts, stats = _run_port(dense_state, carried=True)
    assert len(pts) == len(ref) > 50
    np.testing.assert_allclose(pts, ref, rtol=0, atol=POINTS_M)
    assert stats["tracks"] >= len(pts) and stats["pairs"] == 15  # every pair of the 6 images
    assert abs(np.median(pts[:, 2])) < 0.5  # on the flat ground at z = 0


def test_densify_mesh_with_own_extraction(dense_state):
    """The port re-extracts its own dense sets (its keypoints differ from
    the reference's by ~1e-4 px, ROADMAP 3b): 577 points on both sides, the
    median distance to the nearest reference point under 1e-4 m (my CPU
    run)."""
    import scipy.spatial

    graph, ref = dense_state[0], dense_state[-1]
    pts, stats = _run_port(dense_state, carried=False)
    assert abs(len(pts) - len(ref)) <= OWN_COUNT_REL * len(ref)
    dist, _ = scipy.spatial.cKDTree(ref).query(pts)
    assert np.median(dist) <= OWN_MEDIAN_M
    assert set(stats["features"]) == {nid for nid, _ in graph.nodes()}
