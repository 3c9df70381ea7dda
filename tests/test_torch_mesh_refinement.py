"""The port's MESH_REFINEMENT, INITIAL_GLOBAL_RELAX and FINAL_GLOBAL_RELAX
against the JAX ``Pipeline`` on one 2 x 3 PGM survey at 320 x 240 over 8 m of
sinusoidal relief (70 m wavelength), with the port's relax in float64 and
CAMERA_PARAMETER_RELAX skipped on both sides.

Both runs start from the reference's INITIAL_PROCESSING state (graph,
surfaces, camera models, GPS positions), so every pass starts from the same
inputs. INITIAL_PROCESSING's own parity is tests/test_torch_pipeline.py: on
this relief survey the port's keypoints differ from the reference's by up to
1.5e-3 px (float32 blur order), which moves one inlier on two edges, and the
ground-plane relax of a relief survey turns that into 2e-2 rad.

Tolerances: each pass within 1e-6 rad and 1e-6 m of the reference's, with
equal mesh topology; the whole run with equal passes per state and an equal
final triangle count, orientations within 1e-3 rad and vertex heights within
0.05 m. The JAX side runs INITIAL_PROCESSING in its float32 blur mode,
restored after.
"""

import copy

import numpy as np
import pytest
import torch

from opencalibration_tpu.ops import features as JF
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
from opencalibration_tpu_torch.testing import survey as TS
from tests import synthetic_survey as JS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PASS_RAD, PASS_M = 1e-6, 1e-6
ORIENTATION_RAD, HEIGHT_M = 1e-3, 0.05
RELIEF_M, RELIEF_WAVELENGTH_M = 8.0, 70.0


def _drive(p):
    """Run from the current state to GENERATE_THUMBNAIL; one record per
    ``iterate_once``: the state it ran, the mesh, and each image's
    orientation by path."""
    p.skip_camera_param_relax = True
    log = []
    while p.get_state() != PipelineState.GENERATE_THUMBNAIL:
        state = p.get_state()
        p.iterate_once()
        mesh = p.surfaces[0].mesh
        log.append(dict(
            state=state, vertices=np.array(mesh.vertices), triangles=np.array(mesh.triangles),
            orientation={n.payload.path: np.asarray(n.payload.orientation, np.float64) for _, n in p.graph.nodes()},
        ))
        assert len(log) < 60, "no GENERATE_THUMBNAIL after 60 passes"
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference log, port log, port refresh_problem calls) of the run from
    the reference's INITIAL_PROCESSING state to GENERATE_THUMBNAIL."""
    paths, _, _ = TS.write_survey(str(tmp_path_factory.mktemp("relief_survey")), 2, 3, relief_amplitude=RELIEF_M,
                                  relief_wavelength=RELIEF_WAVELENGTH_M, device="cpu")
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    try:
        ref = JPipeline(batch_size=3)
        ref.add(paths)
        while ref.get_state() == PipelineState.INITIAL_PROCESSING:
            ref.iterate_once()
    finally:
        JF.set_blur_precision(prior)

    port = Pipeline(batch_size=3, device="cpu", dtype=torch.float64)
    for attr in ("graph", "surfaces", "gps_positions"):
        setattr(port, attr, copy.deepcopy(getattr(ref, attr)))
    port.model_store = {mid: interop.camera_from(m, "cpu") for mid, m in ref.model_store.items()}
    port.reset_state(PipelineState.MESH_REFINEMENT)

    refreshes = []
    refresh = ST.refresh_problem

    def counting(*args, **kw):
        refreshes.append(1)
        return refresh(*args, **kw)

    ST.refresh_problem = counting
    try:
        port_log = _drive(port)
    finally:
        ST.refresh_problem = refresh
    return _drive(ref), port_log, len(refreshes)


def _angle(a, b):
    return float(JQ.quat_angle(JQ.quat_multiply(a, JQ.quat_conjugate(b))))


def _compare(got, ref):
    """(max orientation angle in rad, max vertex distance in m) between two
    pass records of the same mesh topology."""
    np.testing.assert_array_equal(got["triangles"], ref["triangles"])
    assert got["orientation"].keys() == ref["orientation"].keys()
    ori = max(_angle(got["orientation"][k], ref["orientation"][k]) for k in ref["orientation"])
    return ori, float(np.abs(got["vertices"] - ref["vertices"]).max())


def test_relief_render_matches_reference():
    """The port's renderer marches rays onto the same height field as the
    JAX fixture's: the 2 x 3 views over the relief agree within 1e-4 of
    the [0, 1] grey range, and differ from the flat views."""
    pos, q = TS.camera_grid(2, 3, spacing=15.0)
    tex = TS.make_texture(0)
    kw = dict(relief_amplitude=RELIEF_M, relief_wavelength=RELIEF_WAVELENGTH_M)
    want = np.stack(JS.render_views(JS.make_texture(0), pos, q, **kw)).astype(np.float32)
    got = TS.render_views(tex, pos, q, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    flat = TS.render_views(tex, pos, q, device="cpu").numpy()
    assert np.abs(got - flat).mean() > 1e-2
    xy = torch.tensor([[17.5, 0.0], [0.0, 0.0]], dtype=torch.float64)
    np.testing.assert_allclose(TS.relief_height(xy, RELIEF_M, RELIEF_WAVELENGTH_M).numpy(), [RELIEF_M, 0.0],
                               atol=1e-12)


def test_first_pass_from_identical_inputs(runs):
    ref, got, _ = runs
    assert ref[0]["state"] == got[0]["state"] == PipelineState.MESH_REFINEMENT
    ori, dz = _compare(got[0], ref[0])
    print(f"first MESH_REFINEMENT pass: orientations {ori:.3g} rad, vertices {dz:.3g} m apart")
    assert ori <= PASS_RAD and dz <= PASS_M
    assert len(ref[0]["triangles"]) > 1  # the pass refined the minimal mesh


def test_every_pass_matches(runs):
    ref, got, _ = runs
    assert [r["state"] for r in got] == [r["state"] for r in ref]
    worst = [_compare(g, r) for g, r in zip(got, ref)]
    print("per pass (rad, m):", [(f"{o:.2g}", f"{z:.2g}") for o, z in worst])
    assert max(o for o, _ in worst) <= PASS_RAD and max(z for _, z in worst) <= PASS_M


def test_whole_run_matches_reference(runs):
    ref, got, refreshes = runs

    def passes(log):
        return {s: sum(r["state"] == s for r in log) for s in PipelineState.ORDER}

    assert passes(got) == passes(ref)
    n_refine = passes(ref)[PipelineState.MESH_REFINEMENT]
    assert n_refine >= 5 and passes(ref)[PipelineState.FINAL_GLOBAL_RELAX] == 4
    assert len(got[-1]["triangles"]) == len(ref[-1]["triangles"]) > 50
    ori = max(_angle(got[-1]["orientation"][k], ref[-1]["orientation"][k]) for k in ref[-1]["orientation"])
    dz = float(np.abs(got[-1]["vertices"][:, 2] - ref[-1]["vertices"][:, 2]).max())
    print(f"{n_refine} MESH_REFINEMENT passes, {len(ref[-1]['triangles'])} triangles; final orientations "
          f"{ori:.3g} rad, heights {dz:.3g} m apart; {refreshes} cached-plan refreshes")
    assert ori <= ORIENTATION_RAD and dz <= HEIGHT_M
    # FINAL_GLOBAL_RELAX re-solved its cached problems instead of rebuilding them
    assert refreshes >= 2
