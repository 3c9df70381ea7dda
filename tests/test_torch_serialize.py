"""The port's graph serializer and checkpoint (opencalibration_tpu_torch/io)
against the JAX package's: the same JSON document, files read across the two
packages, and a pipeline that resumes from a checkpoint.

Tolerances: a serialised graph comes back exactly (arrays bit for bit, ids,
camera-model leaves as float64). A checkpoint stores mesh vertices with 10
significant digits and cloud points with 6 decimals (the formats of
``io/mesh_io.py``), so a resumed run is held to the uninterrupted one within
1e-6 rad on orientations and 1e-5 m on mesh heights, with equal states, edge
sets and inlier sets.
"""

import copy
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.geo.geo_coord import GeoCoord as JGeoCoord
from opencalibration_tpu.io import checkpoint as JCK
from opencalibration_tpu.io import serialize as JSER
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
from opencalibration_tpu_torch.io import checkpoint as TCK
from opencalibration_tpu_torch.io import mesh_io as TMIO
from opencalibration_tpu_torch.io import serialize as TSER
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.testing import survey as TS
from opencalibration_tpu_torch.types import graph as TG
from opencalibration_tpu_torch.types.camera import LEAVES
from tests.test_torch_camera_relax import _graph_with_matches
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RESUME_RAD, RESUME_M = 1e-6, 1e-5


@pytest.fixture(scope="module")
def linked():
    """A linked 2 x 3 survey graph (features, match and inlier lists, one
    image without an orientation yet) in both packages' containers, with a
    two-model store (one FORWARD model with distortion, one INVERSE)."""
    graph, ids, j_models = _graph_with_matches()
    graph.get_node(ids[-1]).payload.orientation = np.full(4, np.nan)
    graph.get_node(ids[0]).payload.metadata.camera_make = "Synthetic"
    graph.get_node(ids[0]).payload.metadata.abs_orientation = np.asarray([1.0, 0.0, 0.0, 0.0])
    j_models[5] = JCameraModel.create(410.5, (159.25, 121.0), (0.03, -0.004, 0.0005), (1e-4, -2e-4), 320, 240,
                                      tag="inverse", dtype=jnp.float64)
    return graph, interop.graph_from(graph), j_models, interop.model_store_from(j_models)


def _assert_models_equal(got, ref):
    """Port model store against a JAX-package one: every leaf, float64."""
    assert sorted(got) == sorted(ref)
    for mid, m in got.items():
        assert m.tag == ref[mid].tag and m.dtype == torch.float64 and m.focal_length_pixels.device.type == "cpu"
        for leaf in LEAVES:
            np.testing.assert_array_equal(getattr(m, leaf).numpy(), np.asarray(getattr(ref[mid], leaf)), err_msg=leaf)


def test_port_round_trip_is_exact(linked):
    _, t_graph, j_models, t_models = linked
    text = TSER.serialize_graph(t_graph, t_models)
    graph, models = TSER.deserialize_graph(text)
    assert isinstance(graph, TG.DirectedGraph) and graph == t_graph
    assert sorted(graph.node_ids()) == sorted(t_graph.node_ids())
    assert sorted(graph.edge_ids()) == sorted(t_graph.edge_ids())
    for nid in t_graph.node_ids():
        assert graph.get_node(nid).edges == t_graph.get_node(nid).edges
        assert graph.get_node(nid).payload.thumbnail is None
    for eid, e in t_graph.edges():
        assert graph.get_edge_id(e.source, e.dest) == eid
        for name in ("match_idx1", "inlier_pixel1", "rel_quats", "ransac_relation"):
            have, want = getattr(graph.get_edge(eid).payload, name), getattr(e.payload, name)
            assert np.asarray(have).dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(have, want)
    _assert_models_equal(models, j_models)
    assert TSER.serialize_graph(graph, models) == text  # and a second trip writes the same bytes
    with pytest.raises(ValueError, match="version"):
        TSER.deserialize_graph(json.dumps(dict(version=99, nodes={}, edges={})))


def test_documents_are_the_same_and_cross_read(linked):
    j_graph, t_graph, j_models, t_models = linked
    j_text = JSER.serialize_graph(j_graph, j_models)
    t_text = TSER.serialize_graph(t_graph, t_models)
    assert json.loads(t_text) == json.loads(j_text)  # same keys, same array encoding, same values
    # the JAX package reads the port's file
    graph, models = JSER.deserialize_graph(t_text)
    assert isinstance(graph, JG.DirectedGraph) and graph == j_graph
    _assert_models_equal(t_models, models)
    # the port reads the JAX package's file
    graph, models = TSER.deserialize_graph(j_text)
    assert graph == t_graph
    _assert_models_equal(models, j_models)
    # and carried back by attribute, it is the JAX package's graph again
    assert interop.graph_from(graph, JG) == j_graph


def test_thumbnail_needs_cv2_or_is_null(linked, monkeypatch):
    """A node without a thumbnail serialises as null. A thumbnail is a PNG of
    the port's own codec: with ``import cv2`` failing it is written and read
    back equal, and the JAX package's (OpenCV) reader decodes the same array."""
    _, t_graph, _, t_models = linked
    assert all(n["thumbnail"] is None for n in json.loads(TSER.serialize_graph(t_graph, t_models))["nodes"].values())
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kw)

    thumb = np.random.default_rng(0).integers(0, 256, (43, 58, 3), dtype=np.uint8)
    with monkeypatch.context() as m:
        m.setattr(builtins, "__import__", no_cv2)
        text = TSER._enc_png(thumb)
        np.testing.assert_array_equal(TSER._dec_png(text), thumb)
        assert TSER._enc_png(None) is None and TSER._dec_png(None) is None
    np.testing.assert_array_equal(JSER._dec_png(text), thumb)
    np.testing.assert_array_equal(TSER._dec_png(JSER._enc_png(thumb)), thumb)


def test_visualized_geojson_matches_reference(linked):
    j_graph, t_graph, _, _ = linked
    j_geo, t_geo = JGeoCoord(), GeoCoord()
    # without an origin no camera is placed (the links are still listed, as in the reference)
    kinds = [f["geometry"]["type"] for f in json.loads(TSER.to_visualized_geojson(t_graph, t_geo))["features"]]
    assert "Point" not in kinds and len(kinds) == len(json.loads(JSER.to_visualized_geojson(j_graph, j_geo))["features"])
    j_geo.set_origin(47.4, 8.5)
    t_geo.set_origin(47.4, 8.5)
    got = json.loads(TSER.to_visualized_geojson(t_graph, t_geo))
    assert got == json.loads(JSER.to_visualized_geojson(j_graph, j_geo))
    kinds = [f["geometry"]["type"] for f in got["features"]]
    assert kinds.count("Point") == 6 and kinds.count("LineString") == t_graph.size_edges()


def test_mesh_io_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    mesh = interop.mesh_from(_grid(rng))
    TMIO.save_ply(str(tmp_path / "m.ply"), mesh)
    back = TMIO.load_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(back.triangles, mesh.triangles)
    np.testing.assert_allclose(back.vertices, mesh.vertices, rtol=1e-9)
    pts = rng.normal(size=(40, 3)) * [30.0, 30.0, 2.0]
    pts[0, 2] = 500.0  # an outlier in height
    TMIO.save_xyz(str(tmp_path / "c.xyz"), pts)
    np.testing.assert_allclose(TMIO.load_xyz(str(tmp_path / "c.xyz")), pts, atol=5e-7)
    TMIO.save_xyz(str(tmp_path / "f.xyz"), pts, filter_stddev=3.0)
    assert len(TMIO.load_xyz(str(tmp_path / "f.xyz"))) == 39


def _grid(rng):
    from tests.test_torch_ground_mesh import _grid_mesh

    return _grid_mesh(rng, z_scale=0.7)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _drive(p, until=None):
    """Iterate to GENERATE_THUMBNAIL, or to the entry of state ``until``."""
    states = []
    while p.get_state() not in (PipelineState.GENERATE_THUMBNAIL, until):
        states.append(p.get_state())
        p.iterate_once()
        assert len(states) < 80
    return states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A flat 2 x 2 survey with a 5 % wrong focal tag, run by the port in
    float64 with every state on. At the entry of CAMERA_PARAMETER_RELAX the
    run is saved, and a copy of its state kept; it then runs on without a
    stop, and a fresh pipeline loads the checkpoint and runs on from it."""
    d = tmp_path_factory.mktemp("ck_survey")
    paths, _, _ = TS.write_survey(str(d), 2, 2, focal_px_tag=420.0, device="cpu")

    def make():
        return Pipeline(batch_size=4, device="cpu", dtype=torch.float64)

    whole = make()
    whole.add(paths)
    whole_states = _drive(whole, until=PipelineState.CAMERA_PARAMETER_RELAX)
    ck = str(d / "checkpoint")
    assert whole.save_checkpoint(ck)
    saved = types.SimpleNamespace(
        graph=interop.graph_from(whole.graph), gps_positions=copy.deepcopy(whole.gps_positions),
        model_store=dict(whole.model_store), origin=whole.geocoord.origin,
        surfaces=[interop.surface_from(s) for s in whole.surfaces],
    )
    whole_states += _drive(whole)

    resumed = make()
    assert resumed.load_checkpoint(ck)
    at_load = dict(state=resumed.get_state(), graph_equal=resumed.graph == saved.graph,
                   run_count=resumed.state_run_count())
    resumed_states = _drive(resumed)
    return dict(whole=whole, whole_states=whole_states, first=saved, resumed=resumed, at_load=at_load,
                resumed_states=resumed_states, ck=ck)


def test_checkpoint_round_trip(runs):
    first, ck = runs["first"], runs["ck"]
    assert sorted(os.listdir(ck)) == ["graph.json", "metadata.json", "pointcloud_0_0.xyz", "surface_0.ply"]
    assert runs["at_load"] == dict(state=PipelineState.CAMERA_PARAMETER_RELAX, graph_equal=True, run_count=0)
    p = Pipeline(device="cpu")
    assert p.load_checkpoint(ck)
    assert p.graph == first.graph and sorted(p.gps_positions) == sorted(first.gps_positions)
    for nid, xy in first.gps_positions.items():
        np.testing.assert_array_equal(p.gps_positions[nid], xy)
    assert p.geocoord.origin == first.origin
    for mid, m in first.model_store.items():
        for leaf in LEAVES:
            assert torch.equal(getattr(p.model_store[mid], leaf), getattr(m, leaf))
    assert len(p.surfaces) == len(first.surfaces) == 1
    np.testing.assert_array_equal(p.surfaces[0].mesh.triangles, first.surfaces[0].mesh.triangles)
    np.testing.assert_allclose(p.surfaces[0].mesh.vertices, first.surfaces[0].mesh.vertices, rtol=1e-9)
    np.testing.assert_allclose(p.surfaces[0].cloud[0], first.surfaces[0].cloud[0], atol=5e-7)
    # a directory without a checkpoint, or of another version, is refused
    assert not Pipeline(device="cpu").load_checkpoint(os.path.dirname(ck))
    assert TCK.validate_checkpoint(ck)
    # rewind only
    assert p.resume_from_state(PipelineState.MESH_REFINEMENT) and p.state_run_count() == 0
    assert not p.resume_from_state(PipelineState.FINAL_GLOBAL_RELAX)


def test_checkpoint_is_read_by_the_reference(runs):
    """The directory the port writes loads into the JAX package's pipeline,
    and the one the JAX package writes from it loads into the port's."""
    first, ck = runs["first"], runs["ck"]
    ref = JPipeline()
    assert JCK.load_checkpoint(ck, ref)
    assert ref.get_state() == PipelineState.CAMERA_PARAMETER_RELAX
    assert interop.graph_from(ref.graph) == first.graph
    np.testing.assert_array_equal(ref.surfaces[0].mesh.triangles, first.surfaces[0].mesh.triangles)
    back = os.path.join(os.path.dirname(ck), "from_reference")
    assert JCK.save_checkpoint(back, ref)
    p = Pipeline(device="cpu")
    assert p.load_checkpoint(back) and p.graph == first.graph
    # the same document, but for the thumbnails' PNG bytes (each package deflates with its own
    # encoder): those are compared decoded
    with open(os.path.join(ck, "graph.json")) as a, open(os.path.join(back, "graph.json")) as b:
        doc_a, doc_b = json.load(a), json.load(b)
    assert doc_a["nodes"].keys() == doc_b["nodes"].keys()
    for nid in doc_a["nodes"]:
        thumb_a, thumb_b = doc_a["nodes"][nid].pop("thumbnail"), doc_b["nodes"][nid].pop("thumbnail")
        np.testing.assert_array_equal(TSER._dec_png(thumb_a), TSER._dec_png(thumb_b))
    assert doc_a == doc_b
    with open(os.path.join(ck, "metadata.json")) as a, open(os.path.join(back, "metadata.json")) as b:
        assert json.load(a) == json.load(b)


def test_resumed_run_reaches_the_same_final_state(runs):
    whole, resumed = runs["whole"], runs["resumed"]
    assert whole.get_state() == resumed.get_state() == PipelineState.GENERATE_THUMBNAIL
    tail = runs["whole_states"][runs["whole_states"].index(PipelineState.CAMERA_PARAMETER_RELAX):]
    assert runs["resumed_states"] == tail and tail.count(PipelineState.CAMERA_PARAMETER_RELAX) == 6
    a = {n.payload.path: n.payload for _, n in whole.graph.nodes()}
    b = {n.payload.path: n.payload for _, n in resumed.graph.nodes()}
    assert a.keys() == b.keys()
    worst = 0.0
    for path in a:
        qa, qb = a[path].orientation, b[path].orientation
        worst = max(worst, 2.0 * np.arccos(min(1.0, abs(float(np.dot(qa, qb))))))
        np.testing.assert_array_equal(a[path].position, b[path].position)
    ea = {(e.source, e.dest): e.payload for _, e in whole.graph.edges()}
    eb = {(e.source, e.dest): e.payload for _, e in resumed.graph.edges()}
    assert ea.keys() == eb.keys()
    for k in ea:
        np.testing.assert_array_equal(ea[k].inlier_match_index, eb[k].inlier_match_index)
    va, vb = whole.surfaces[0].mesh.vertices, resumed.surfaces[0].mesh.vertices
    np.testing.assert_array_equal(whole.surfaces[0].mesh.triangles, resumed.surfaces[0].mesh.triangles)
    dz = float(np.abs(va - vb).max())
    fa = float(whole.model_store[1].focal_length_pixels)
    fb = float(resumed.model_store[1].focal_length_pixels)
    print(f"resumed vs uninterrupted: orientations {worst:.3g} rad, mesh {dz:.3g} m, focal {fa:.6f} vs {fb:.6f}")
    assert worst <= RESUME_RAD and dz <= RESUME_M and abs(fa - fb) <= 1e-6 * fa
