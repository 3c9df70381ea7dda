"""The port's reference-format graph.json interchange
(``opencalibration_tpu_torch/io/interchange.py``) against the JAX package's
``io/interchange.py``: the cases of tests/test_interchange.py on the port,
a graph written by either package and read by the other, and the port's
reader in a process where jax, the JAX package and cv2 cannot be imported.

The graph is the port's INITIAL_PROCESSING state of a 2 x 2 survey at
320 x 240 on the CPU, Lab thumbnails included. Tolerances: node ids, paths,
feature counts, descriptors, match and inlier indices and relation types
equal; thumbnails equal byte for byte after decoding (the two packages'
PNG encoders compress differently); positions, poses, relations and relative
poses within 1e-12; keypoints within 1e-5 px (the schema's float32
locations); the re-linked and re-relaxed graph's orientations within 15
degrees of the pipeline's, as the reference's own test asks.
"""

import base64
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from opencalibration_tpu.io import interchange as JI
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.io import interchange as TI
from opencalibration_tpu_torch.ops.quaternion import quat_rotate
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.pipeline.stages import LinkStage, RelaxStage
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.testing import survey as TS
from tests.test_interchange import _our_pack_bits, _reference_pack_bits
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-12
XY_PX = 1e-5
RELINK_DEG = 15.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """The port's pipeline after INITIAL_PROCESSING on a 2 x 2 survey."""
    paths, _, _ = TS.write_survey(str(tmp_path_factory.mktemp("interchange")), 2, 2, device="cpu")
    p = Pipeline(batch_size=4, device="cpu")
    p.add(paths)
    while p.get_state() == PipelineState.INITIAL_PROCESSING:
        p.iterate_once()
    assert p.graph.size_edges() >= 3
    return p


def _assert_same_graph(got, want, models_got, models_want):
    assert sorted(got.node_ids()) == sorted(want.node_ids())
    for nid in want.node_ids():
        a, b = want.get_node(nid).payload, got.get_node(nid).payload
        assert a.path == b.path and a.model_id == b.model_id
        np.testing.assert_allclose(b.position, a.position, rtol=0, atol=POSE_TOL)
        np.testing.assert_allclose(b.orientation, a.orientation, rtol=0, atol=POSE_TOL)
        fa, fb = a.features, b.features
        n = int(np.sum(fa.valid))
        assert int(np.sum(fb.valid)) == n
        np.testing.assert_allclose(fb.xy[:n], fa.xy[fa.valid][:n], rtol=0, atol=XY_PX)
        np.testing.assert_array_equal(np.asarray(fb.descriptors[:n], np.uint32),
                                      np.asarray(fa.descriptors[fa.valid][:n], np.uint32))
        if a.thumbnail is None:
            assert b.thumbnail is None
        else:
            np.testing.assert_array_equal(b.thumbnail, a.thumbnail)
    assert sorted(eid for eid, _ in got.edges()) == sorted(eid for eid, _ in want.edges())
    for eid, e in want.edges():
        r, r2 = e.payload, got.get_edge(eid).payload
        assert (got.get_edge(eid).source, got.get_edge(eid).dest) == (e.source, e.dest)
        for k in ("match_idx1", "match_idx2", "inlier_idx1", "inlier_idx2", "inlier_match_index"):
            np.testing.assert_array_equal(getattr(r2, k), getattr(r, k), err_msg=k)
        assert str(r2.relation_type) == str(r.relation_type)
        for k in ("ransac_relation", "rel_quats", "rel_positions", "inlier_pixel1", "inlier_pixel2"):
            np.testing.assert_allclose(np.asarray(getattr(r2, k)), np.asarray(getattr(r, k)), rtol=0, atol=POSE_TOL,
                                       err_msg=k)
    assert sorted(models_got) == sorted(models_want)
    for mid in models_want:
        for k in ("focal_length_pixels", "principal_point", "radial_distortion", "pixels_cols", "pixels_rows"):
            np.testing.assert_allclose(np.asarray(getattr(models_got[mid], k)), np.asarray(getattr(models_want[mid], k)),
                                       rtol=0, atol=POSE_TOL, err_msg=k)


@pytest.mark.parametrize("seed", [42, 7])
def test_descriptor_bit_layout_matches_reference_bitset(seed):
    bits = np.random.RandomState(seed).rand(TI.DESCRIPTOR_BITS) > 0.5
    ref_bytes = _reference_pack_bits(bits)
    loaded = TI._desc_from_b64(base64.b64encode(ref_bytes).decode())
    np.testing.assert_array_equal(loaded, _our_pack_bits(bits))
    assert base64.b64decode(TI._desc_to_b64(loaded)) == ref_bytes
    assert TI._desc_to_b64(loaded) == JI._desc_to_b64(loaded)


def test_roundtrip_preserves_everything(calibrated):
    p = calibrated
    assert all(n.payload.thumbnail is not None for _, n in p.graph.nodes())
    text = TI.save_reference_graph(p.graph, p.model_store)
    assert json.loads(text)["version"] == 1
    graph, models = TI.load_reference_graph(text)
    _assert_same_graph(graph, p.graph, models, p.model_store)
    assert models[1].dtype == torch.float64


def test_a_graph_written_by_either_package_reads_in_the_other(calibrated):
    p = calibrated
    t_text = TI.save_reference_graph(p.graph, p.model_store)
    j_graph, j_models = JI.load_reference_graph(t_text)
    _assert_same_graph(j_graph, p.graph, j_models, p.model_store)
    j_text = JI.save_reference_graph(interop.graph_from(p.graph, JG), p.model_store)
    graph, models = TI.load_reference_graph(j_text)
    _assert_same_graph(graph, p.graph, models, p.model_store)
    # the same document but for the thumbnails' PNG bytes
    t_doc, j_doc = json.loads(t_text), json.loads(j_text)
    for doc in (t_doc, j_doc):
        for node in doc["nodes"].values():
            node.pop("thumbnail")
    assert t_doc == j_doc


def test_reference_features_drive_link_and_relax(calibrated):
    """Only the nodes and features of a round-tripped graph, linked and
    relaxed again: the orientations come back near the pipeline's."""
    p = calibrated
    graph, models = TI.load_reference_graph(TI.save_reference_graph(p.graph, p.model_store))
    for eid in [eid for eid, _ in list(graph.edges())]:
        graph.remove_edge(eid)
    gps = {nid: np.asarray(graph.get_node(nid).payload.position[:2]) for nid in graph.node_ids()}
    for nid in graph.node_ids():
        graph.get_node(nid).payload.orientation = np.full(4, np.nan)
    link = LinkStage(device="cpu")
    link.init(graph, gps, sorted(graph.node_ids()))
    link.run(graph, models)
    linked = link.finalize(graph)
    assert len(linked) >= 4
    stage = RelaxStage(device="cpu", dtype=torch.float64)
    stage.init(graph, linked, gps, models, relax_all=True, disable_parallelism=True,
               options=RelaxOptions(orientation=True, ground_plane=True))
    stage.run_all(graph, [])
    stage.finalize(graph, models)
    z = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)

    def tilt_deg(q):
        down = quat_rotate(torch.as_tensor(np.asarray(q, np.float64))[None], z)[0].numpy()
        return np.degrees(np.arccos(np.clip(-down[2], -1, 1)))

    for nid in graph.node_ids():
        q = graph.get_node(nid).payload.orientation
        assert np.isfinite(q).all()
        assert abs(tilt_deg(q) - tilt_deg(p.graph.get_node(nid).payload.orientation)) < RELINK_DEG


_STANDALONE = """
import json, sys
for name in ("jax", "opencalibration_tpu", "cv2"):
    sys.modules[name] = None  # any import of it raises
from opencalibration_tpu_torch.io.interchange import load_reference_graph
graph, models = load_reference_graph(open(sys.argv[1]).read())
thumbs = sum(n.payload.thumbnail is not None for _, n in graph.nodes())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "opencalibration_tpu", "cv2") and sys.modules[m])
print(json.dumps(dict(nodes=graph.size_nodes(), edges=graph.size_edges(), thumbs=thumbs, loaded=loaded)))
"""


def test_the_ports_reader_needs_no_jax_and_no_cv2(calibrated, tmp_path):
    p = calibrated
    path = tmp_path / "graph.json"
    path.write_text(JI.save_reference_graph(interop.graph_from(p.graph, JG), p.model_store))
    r = subprocess.run([sys.executable, "-c", _STANDALONE, str(path)], capture_output=True, text=True, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == dict(nodes=p.graph.size_nodes(), edges=p.graph.size_edges(), thumbs=p.graph.size_nodes(), loaded=[])
