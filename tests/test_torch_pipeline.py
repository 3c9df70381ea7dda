"""The port's pipeline (opencalibration_tpu_torch.pipeline.pipeline) through
INITIAL_PROCESSING against the JAX package's ``Pipeline``, on one 2 x 3 PGM
survey at 320 x 240 with ``batch_size=3``. The port runs its relax problems in
float64, as the reference does with x64 on, and its link stage takes the
reference's RANSAC draw.

Tolerances: equal node paths, ids and positions (1e-9); equal (source, dest)
edge sets; per-edge inlier counts within 2; per-image orientation within
1e-3 rad; surface vertex heights within 0.05 m. The JAX side runs in its
float32 blur mode, restored after.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import features as JF
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ORIENTATION_RAD = 1e-3
POSITION_M = 1e-9
INLIER_COUNT = 2
SURFACE_Z_M = 0.05
HYPOTHESES = 2048


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    return TS.write_survey(str(tmp_path_factory.mktemp("pgm_survey")), 2, 3, device="cpu")


def _initial_processing(p, paths):
    p.add(paths)
    while p.get_state() == PipelineState.INITIAL_PROCESSING:
        p.iterate_once()
    return p


@pytest.fixture(scope="module")
def reference(survey):
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    try:
        return _initial_processing(JPipeline(batch_size=3), survey[0])
    finally:
        JF.set_blur_precision(prior)


@pytest.fixture(scope="module")
def port(survey):
    uniforms = np.array(jax.random.uniform(jax.random.PRNGKey(42), (HYPOTHESES, 4)))
    p = Pipeline(batch_size=3, device="cpu", dtype=torch.float64, ransac_uniforms=torch.from_numpy(uniforms))
    progress = []
    p.step_callback = progress.append
    _initial_processing(p, survey[0])
    p.progress = progress
    return p


def _nodes(p):
    return {n.payload.path: (nid, n.payload) for nid, n in p.graph.nodes()}


def _edges(p):
    path = lambda nid: p.graph.get_node(nid).payload.path  # noqa: E731
    return {(path(e.source), path(e.dest)): e.payload for _, e in p.graph.edges()}


def _angle(a, b):
    return float(JQ.quat_angle(JQ.quat_multiply(np.asarray(a), JQ.quat_conjugate(np.asarray(b)))))


def test_initial_processing_matches_reference(reference, port, survey):
    assert port.get_state() == reference.get_state() == PipelineState.MESH_REFINEMENT
    ref_nodes, got_nodes = _nodes(reference), _nodes(port)
    assert got_nodes.keys() == ref_nodes.keys() == set(survey[0])
    pos_err, ori_err = [], []
    for path, (rid, r) in ref_nodes.items():
        gid, g = got_nodes[path]
        assert gid == rid and g.model_id == r.model_id
        pos_err.append(np.abs(g.position - r.position).max())
        ori_err.append(_angle(g.orientation, r.orientation))
    ref_edges, got_edges = _edges(reference), _edges(port)
    assert got_edges.keys() == ref_edges.keys() and len(ref_edges) == 15
    inlier_diff = [abs(len(got_edges[k].inlier_idx1) - len(ref_edges[k].inlier_idx1)) for k in ref_edges]
    assert len(port.surfaces) == len(reference.surfaces) == 1
    z_err = np.abs(port.surfaces[0].mesh.vertices[:, 2] - reference.surfaces[0].mesh.vertices[:, 2]).max()
    print(f"port vs reference: position {max(pos_err):.3g} m, orientation {max(ori_err):.3g} rad, "
          f"inlier counts {max(inlier_diff)}, surface z {z_err:.3g} m")
    assert max(pos_err) <= POSITION_M
    assert max(ori_err) <= ORIENTATION_RAD
    assert max(inlier_diff) <= INLIER_COUNT
    assert z_err <= SURFACE_Z_M
    # the cameras are recovered: relative positions as surveyed, nadir to a few degrees
    _, positions, quats = survey
    origin = got_nodes[survey[0][0]][1].position
    for i, path in enumerate(survey[0]):
        g = got_nodes[path][1]
        np.testing.assert_allclose(g.position - origin, positions[i] - positions[0], atol=0.5)
        assert _angle(g.orientation, quats[i]) < 0.1


def test_progress_is_reported(port):
    gp = [info.global_progress for info in port.progress]
    assert len(gp) == 4 and all(b >= a for a, b in zip(gp, gp[1:]))
    assert sorted(i for info in port.progress for i in info.loaded_ids) == sorted(port.graph.node_ids())


def test_overlap_matches_serial_order(port, survey):
    """Overlapping decode / link / relax of consecutive batches is a pure
    scheduling change: overlap off gives the same graph."""
    uniforms = port._link_stage.uniforms
    serial = Pipeline(batch_size=3, device="cpu", dtype=torch.float64, ransac_uniforms=uniforms)
    serial.overlap_io = False
    _initial_processing(serial, survey[0])
    a, b = _nodes(port), _nodes(serial)
    assert a.keys() == b.keys()
    for path, (aid, na) in a.items():
        bid, nb = b[path]
        assert aid == bid
        np.testing.assert_array_equal(na.position, nb.position)
        np.testing.assert_array_equal(na.orientation, nb.orientation)
    ea, eb = _edges(port), _edges(serial)
    assert ea.keys() == eb.keys() and all(ea[k] == eb[k] for k in ea)
    np.testing.assert_array_equal(port.surfaces[0].mesh.vertices, serial.surfaces[0].mesh.vertices)


def test_unreadable_path_is_skipped(survey, tmp_path):
    p = Pipeline(batch_size=4, device="cpu")
    _initial_processing(p, [survey[0][0], str(tmp_path / "missing.jpg")])
    assert p.graph.size_nodes() == 1 and p.graph.size_edges() == 0


def test_later_states_raise_and_device_is_required():
    p = Pipeline(device="cpu")
    assert not p.resume_from_state(PipelineState.FINAL_GLOBAL_RELAX)  # no skipping ahead
    # CAMERA_PARAMETER_RELAX is ported: on an empty pipeline its six passes run through
    p.reset_state(PipelineState.CAMERA_PARAMETER_RELAX)
    p.skip_final_global_relax = True
    after = [p.iterate_once() for _ in range(6)]
    assert after == [PipelineState.CAMERA_PARAMETER_RELAX] * 5 + [PipelineState.FINAL_GLOBAL_RELAX]
    assert p.iterate_once() == PipelineState.GENERATE_THUMBNAIL
    # the ortho tail is ported: with no output path set it is passed through
    assert p.run_to_completion() == PipelineState.COMPLETE
    assert p.iterate_once() == "DONE" and p.state_run_count() == 0
    # the dense-mesh states are not, and say where they stand when switched on
    p.reset_state(PipelineState.DENSIFY_MESH)
    p.skip_dense_mesh = False
    with pytest.raises(NotImplementedError, match="Slice D"):
        p.run_to_completion()
    p.skip_dense_mesh = True
    # and it is passed at once when skipped
    p.reset_state(PipelineState.CAMERA_PARAMETER_RELAX)
    p.skip_camera_param_relax = True
    assert p.iterate_once() == PipelineState.FINAL_GLOBAL_RELAX
    assert p.resume_from_state(PipelineState.INITIAL_PROCESSING)
    with pytest.raises(ValueError):
        Pipeline(device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Pipeline(device="cuda")


def test_default_device_is_the_card(monkeypatch):
    """``Pipeline()`` and its stages name no device and get the card: without
    one they raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Pipeline, ST.LoadStage, ST.LinkStage, ST.RelaxStage):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert Pipeline(device="cpu").device == torch.device("cpu")


def test_initial_processing_without_jax(tmp_path):
    """In a process where ``import jax`` and ``import opencalibration_tpu``
    (the JAX package) fail, the port runs a 2 x 2 survey from
    INITIAL_PROCESSING through CAMERA_PARAMETER_RELAX (intrinsics free) and
    FINAL_GLOBAL_RELAX, saves a checkpoint, loads it into a fresh pipeline
    with an equal graph, and no module of either is loaded."""
    code = textwrap.dedent(f"""
        import os, sys
        sys.modules["jax"] = None  # any import of jax raises
        sys.modules["opencalibration_tpu"] = None  # and of the JAX package (not the port's prefix)
        from opencalibration_tpu_torch.testing import survey
        from opencalibration_tpu_torch.pipeline.pipeline import Pipeline
        paths, _, _ = survey.write_survey({str(tmp_path)!r}, 2, 2, focal_px_tag=420.0, device="cpu")
        p = Pipeline(batch_size=4, device="cpu")
        p.add(paths)
        states = []
        while p.get_state() != "GENERATE_THUMBNAIL":
            states.append(p.get_state())
            p.iterate_once()
        ck = os.path.join({str(tmp_path)!r}, "checkpoint")
        assert p.save_checkpoint(ck)
        q = Pipeline(device="cpu")
        assert q.load_checkpoint(ck) and q.graph == p.graph and q.get_state() == p.get_state()
        assert sorted(q.model_store) == sorted(p.model_store) and len(q.surfaces) == len(p.surfaces)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu") and sys.modules[m])
        assert any(m.startswith("opencalibration_tpu_torch.io.") for m in sys.modules)
        print(p.get_state(), p.graph.size_nodes(), p.graph.size_edges(), len(p.surfaces),
              states.count("CAMERA_PARAMETER_RELAX"), ",".join(sorted(set(states))), loaded)
    """)
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as in this process (tests/torch_threads.py)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900,
                       cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    state, nodes, edges, surfaces, cpr_passes, states, loaded = r.stdout.split(maxsplit=6)
    assert (state, nodes, surfaces, loaded.strip()) == ("GENERATE_THUMBNAIL", "4", "1", "[]")
    assert states == ",".join(sorted(PipelineState.ORDER[:5])) and cpr_passes == "6"
    assert int(edges) >= 4
