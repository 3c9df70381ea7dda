"""bench_overlap_ab's twin on the CPU: ``run_leg`` on a 6-image survey
(2 x 3) in batches of 2, stopped after INITIAL_PROCESSING, with
``overlap_io`` off and on: each leg's pipelines built with the leg's
setting, the same nodes, poses, edges and edge payloads, each line's ``leg``
and ``overlap_io``, and ``Pipeline.__init__`` restored after each leg and
after a leg that raises. About 65 s alone on this suite's one torch thread.
"""

import numpy as np
import pytest

from opencalibration_tpu_torch.bench import bench_e2e as TB
from opencalibration_tpu_torch.bench import bench_overlap_ab as TOV
from opencalibration_tpu_torch.pipeline import pipeline as TP
from opencalibration_tpu_torch.pipeline.pipeline import PipelineState
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

OVERLAP_IMAGES, OVERLAP_BATCH = 6, 2


class _Recorder:
    """Wraps ``Pipeline.__init__`` under the leg's own wrapper and keeps
    every pipeline built."""

    def __init__(self, mp):
        self.built = []
        orig = TP.Pipeline.__init__

        def recording(p, *a, **k):
            orig(p, *a, **k)
            self.built.append(p)

        self.init = recording
        mp.setattr(TP.Pipeline, "__init__", recording)


def _nodes(p):
    return {node.payload.path: (np.asarray(node.payload.position), np.asarray(node.payload.orientation))
            for _, node in p.graph.nodes()}


def _edges(p):
    paths = {nid: node.payload.path for nid, node in p.graph.nodes()}
    return {(paths[e.source], paths[e.dest]): e.payload for _, e in p.graph.edges()}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(TB, "SURVEY_ROOT", str(tmp_path_factory.mktemp("surveys")))
    mp.delenv("BENCH_E2E_ORTHO", raising=False)
    mp.delenv("BENCH_E2E_CHECKPOINT", raising=False)
    rec = _Recorder(mp)
    out = {}
    try:
        for leg, overlap in (("serial", False), ("overlap", True)):
            line = TOV.run_leg(OVERLAP_IMAGES, overlap, leg, "INITIAL_PROCESSING", device="cpu",
                               batch_size=OVERLAP_BATCH)
            out[leg] = dict(line=line, pipeline=rec.built[-1], restored=TP.Pipeline.__init__ is rec.init)
    finally:
        mp.undo()
    return out


def test_overlap_legs_give_the_same_graph(legs):
    serial, overlap = legs["serial"], legs["overlap"]
    for leg, want in ((serial, False), (overlap, True)):
        assert leg["pipeline"].overlap_io is want and leg["restored"]
        line = leg["line"]
        assert line["overlap_io"] is want and line["final_state"] == PipelineState.MESH_REFINEMENT
        assert line["n_images"] == OVERLAP_IMAGES and line["device"] == "cpu"
    assert serial["line"]["leg"] == "serial" and overlap["line"]["leg"] == "overlap"
    a, b = _nodes(serial["pipeline"]), _nodes(overlap["pipeline"])
    assert a.keys() == b.keys() and len(a) == OVERLAP_IMAGES
    for path, (pos, ori) in a.items():
        np.testing.assert_array_equal(b[path][0], pos)
        np.testing.assert_array_equal(b[path][1], ori)
    ea, eb = _edges(serial["pipeline"]), _edges(overlap["pipeline"])
    assert ea.keys() == eb.keys() and all(ea[k] == eb[k] for k in ea) and serial["line"]["n_edges"] == len(ea) > 0


def test_a_leg_that_raises_restores_the_pipeline(monkeypatch):
    orig = TP.Pipeline.__init__
    built = []

    def failing(*a, **k):
        built.append(TP.Pipeline(device="cpu"))  # built under the leg's wrapper
        raise RuntimeError("leg failed")

    monkeypatch.setattr(TB, "run_config", failing)
    with pytest.raises(RuntimeError, match="leg failed"):
        TOV.run_leg(OVERLAP_IMAGES, False, "serial", device="cpu")
    assert built[0].overlap_io is False and TP.Pipeline.__init__ is orig
    assert TP.Pipeline(device="cpu").overlap_io is True

