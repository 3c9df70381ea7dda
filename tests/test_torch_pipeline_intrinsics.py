"""The port's CAMERA_PARAMETER_RELAX state against the JAX ``Pipeline``, pass
for pass, on a 3 x 3 PGM survey at 320 x 240 over 8 m of relief with
row-varied altitude and a focal tag 5 % above the true 400 px, the port's
relax in float64.

Both pipelines enter the state from ONE state: the port runs the survey from
its images through INITIAL_PROCESSING and MESH_REFINEMENT (with the
reference's RANSAC draw, as tests/test_torch_pipeline.py does), and
``interop`` carries that state's graph, surfaces, camera models and GPS
index into the JAX ``Pipeline``. (Those two states have their own parity
tests, tests/test_torch_pipeline.py and tests/test_torch_mesh_refinement.py;
the port reaches the entry state in half the time the JAX package needs
here.) Then each side runs its six passes (focal; focal; + k1; + k2; + k3 and
the principal point; the same again) and the edge refit. tests/test_torch_pipeline_multigroup.py
repeats the comparison with the survey split into intrinsics groups of 3,
which takes the joint solver with the camera model and the surface shared.

Tolerances: per pass focal within 1e-4 relative, principal point within
1e-4 px, radial terms within 1e-4, orientations within 1e-4 rad and mesh
heights within 1e-3 m (the LM is not held tighter than 1e-4); edge inlier
sets after the refit equal. The recovered focal is held to the JAX package's
own bound (tests/test_intrinsics_e2e.py): within 3 % of the truth.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.pipeline import stages as JST
from opencalibration_tpu.pipeline.pipeline import Pipeline as JPipeline
from opencalibration_tpu.relax import problem_builder as JPB
from opencalibration_tpu.relax import relax as JR
from opencalibration_tpu.surface.mesh import TriMesh as JTriMesh
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.pipeline import stages as ST
from opencalibration_tpu_torch.pipeline.pipeline import RELAX_MAX_ITERATIONS, Pipeline, PipelineState
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPR = PipelineState.CAMERA_PARAMETER_RELAX
TRUE_FOCAL, TAG_FOCAL = 400.0, 420.0
PASS_FOCAL_REL, PASS_PX, PASS_RADIAL, PASS_RAD, PASS_M = 1e-4, 1e-4, 1e-4, 1e-4, 1e-3
FOCAL_BOUND = 0.03
HYPOTHESES = 2048


class _Counting:
    """Counts calls of ``module.name`` while active."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self._orig = getattr(module, name)

    def __enter__(self):
        def counting(*args, **kw):
            self.calls += 1
            return self._orig(*args, **kw)

        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def _entry_state(directory, rows, cols):
    """The port's state at the entry of CAMERA_PARAMETER_RELAX on the
    ``rows`` x ``cols`` survey written into ``directory``, and the survey's
    ground truth."""
    paths, positions, quats = TS.write_survey(directory, rows, cols, focal_px_tag=TAG_FOCAL, relief_amplitude=8.0,
                                              device="cpu")
    uniforms = np.array(jax.random.uniform(jax.random.PRNGKey(42), (HYPOTHESES, 4)))
    p = Pipeline(batch_size=rows * cols, device="cpu", dtype=torch.float64, ransac_uniforms=torch.from_numpy(uniforms))
    p.add(paths)
    while p.get_state() != CPR:
        p.iterate_once()
        assert p.get_state() in PipelineState.ORDER[:4]
    assert float(p.model_store[1].focal_length_pixels) == TAG_FOCAL and len(p.model_store) == 1
    assert p.surfaces[0].mesh.num_triangles > 20  # MESH_REFINEMENT followed the relief
    return types.SimpleNamespace(graph=p.graph, surfaces=p.surfaces, gps_positions=p.gps_positions,
                                 model_store=p.model_store, paths=paths, positions=positions, quats=quats)


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    return _entry_state(str(tmp_path_factory.mktemp("intrinsics_survey")), 3, 3)


def _port_at(entry):
    p = Pipeline(batch_size=9, device="cpu", dtype=torch.float64)
    p.graph = interop.graph_from(entry.graph)
    p.surfaces = [interop.surface_from(s) for s in entry.surfaces]
    p.gps_positions = copy.deepcopy(entry.gps_positions)
    p.model_store = dict(entry.model_store)
    p.reset_state(CPR)
    return p


def _reference_at(entry):
    p = JPipeline(batch_size=9)
    p.graph = interop.graph_from(entry.graph, JG)
    p.surfaces = [interop.surface_from(s, JG, JTriMesh) for s in entry.surfaces]
    p.gps_positions = copy.deepcopy(entry.gps_positions)
    p.model_store = {mid: JCameraModel(**{k: (v if k == "tag" else jnp.asarray(v)) for k, v in leaves.items()})
                     for mid, leaves in interop.model_store_to_numpy(entry.model_store).items()}
    p.reset_state(CPR)
    return p


def _record(p):
    m = p.model_store[1]
    mesh = p.surfaces[0].mesh
    return dict(
        focal=float(m.focal_length_pixels), principal=np.asarray(m.principal_point, np.float64).copy(),
        radial=np.asarray(m.radial_distortion, np.float64).copy(), vertices=np.array(mesh.vertices),
        triangles=np.array(mesh.triangles),
        orientation={n.payload.path: np.asarray(n.payload.orientation, np.float64).copy() for _, n in p.graph.nodes()},
    )


def _run_state(p):
    """The passes of CAMERA_PARAMETER_RELAX: one record after each."""
    log = []
    while p.get_state() == CPR:
        p.iterate_once()
        log.append(_record(p))
        assert len(log) <= RELAX_MAX_ITERATIONS + 1
    return log


def _edge_inliers(p):
    path = lambda nid: p.graph.get_node(nid).payload.path  # noqa: E731
    return {(path(e.source), path(e.dest)): e.payload for _, e in p.graph.edges()}


def _both(entry, group_size):
    """(reference, port) after the state, with their pass logs, group counts
    per pass and build / refresh counts, at intrinsics group size
    ``group_size`` on both sides."""
    sizes = (JST.INTRINSICS_GROUP_SIZE, ST.INTRINSICS_GROUP_SIZE)
    JST.INTRINSICS_GROUP_SIZE = ST.INTRINSICS_GROUP_SIZE = group_size
    try:
        out = []
        for make, build_mod, refresh_mod, stage_cls in ((_reference_at, JR, JPB, JST.RelaxStage),
                                                        (_port_at, ST, ST, ST.RelaxStage)):
            p = make(entry)
            groups = []
            run_all = stage_cls.run_all

            def spying(self, *args, _run_all=run_all, _groups=groups, **kw):
                _groups.append(len(self._groups))
                return _run_all(self, *args, **kw)

            stage_cls.run_all = spying
            try:
                with _Counting(build_mod, "build_problem") as builds, _Counting(refresh_mod, "refresh_problem") as refreshes:
                    log = _run_state(p)
            finally:
                stage_cls.run_all = run_all
            out.append(types.SimpleNamespace(pipeline=p, log=log, groups=groups, builds=builds.calls,
                                             refreshes=refreshes.calls))
        return out
    finally:
        JST.INTRINSICS_GROUP_SIZE, ST.INTRINSICS_GROUP_SIZE = sizes


@pytest.fixture(scope="module")
def single(entry):
    return _both(entry, 150)


def _angle(a, b):
    return 2.0 * np.arccos(min(1.0, abs(float(np.dot(a, b)))))


def _assert_passes_match(got, ref):
    assert len(got) == len(ref) == RELAX_MAX_ITERATIONS + 1
    worst = dict(focal=0.0, principal=0.0, radial=0.0, rad=0.0, m=0.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["triangles"], r["triangles"])
        worst["focal"] = max(worst["focal"], abs(g["focal"] / r["focal"] - 1.0))
        worst["principal"] = max(worst["principal"], float(np.abs(g["principal"] - r["principal"]).max()))
        worst["radial"] = max(worst["radial"], float(np.abs(g["radial"] - r["radial"]).max()))
        worst["rad"] = max(worst["rad"], max(_angle(g["orientation"][k], r["orientation"][k]) for k in r["orientation"]))
        worst["m"] = max(worst["m"], float(np.abs(g["vertices"] - r["vertices"]).max()))
    print("worst over the passes:", {k: f"{v:.3g}" for k, v in worst.items()},
          "focal per pass:", [round(g["focal"], 4) for g in got])
    assert worst["focal"] <= PASS_FOCAL_REL and worst["principal"] <= PASS_PX and worst["radial"] <= PASS_RADIAL
    assert worst["rad"] <= PASS_RAD and worst["m"] <= PASS_M


def test_every_pass_matches_reference(single):
    ref, got = single
    assert got.groups == ref.groups == [1] * 6
    _assert_passes_match(got.log, ref.log)
    # the schedule: the focal moves from the first pass, the radial terms not before the third,
    # the principal point not before the fifth
    log = got.log
    assert log[0]["focal"] != TAG_FOCAL
    # The relax frees terms of the INVERSE model; the log holds the FORWARD model that the write-back
    # converts it to. A frozen inverse term is 0, so its forward term is what inverting the free ones
    # gives: with a = -k1 and b = 3 a^2 - k2, k2 = 3 a^2 while b is frozen and k3 = -12 a^3 + 8 a b
    # while c is. The conversion is a least-squares fit over the image, not that series: it is held
    # within SERIES_REL of it, above the floor of the conversion there and back, 1e-12. (Where the
    # passes hardly move k1, as from some entry states, every frozen term is under the floor.)
    floor, SERIES_REL = 1e-12, 0.1
    print("radial terms per pass:", [np.asarray(rec["radial"]).tolist() for rec in log])

    def frozen_k2(k):
        return 3.0 * k[0] ** 2

    def frozen_k3(k):
        a = -k[0]
        return -12.0 * a ** 3 + 8.0 * a * (3.0 * a ** 2 - k[1])

    def at_series(value, series):
        return abs(value - series) <= SERIES_REL * abs(series) + floor

    radial = [np.asarray(rec["radial"], np.float64) for rec in log]
    assert (np.abs(radial[1]) <= floor).all()  # focal only: nothing moved
    k = radial[2]  # + k1
    assert abs(k[0]) > floor and at_series(k[1], frozen_k2(k)) and at_series(k[2], frozen_k3(k))
    k = radial[3]  # + k2
    assert abs(k[0]) > floor and abs(k[1]) > floor and not at_series(k[1], frozen_k2(k))
    assert at_series(k[2], frozen_k3(k))
    assert (np.abs(radial[4]) > floor).all() and abs(radial[4][2] - radial[3][2]) > floor  # + k3
    np.testing.assert_array_equal(log[3]["principal"], [160.0, 120.0])
    assert (log[4]["principal"] != [160.0, 120.0]).all()


def test_one_build_then_refreshes(single):
    """The tier schedule changes values and masks only: the state builds its
    problem once and refreshes it on each of the five later passes, on both
    sides."""
    ref, got = single
    assert (got.builds, got.refreshes) == (1, RELAX_MAX_ITERATIONS)
    assert (ref.builds, ref.refreshes) == (got.builds, got.refreshes)


def test_edges_are_refitted_once_at_the_end(entry, single):
    ref, got = single
    p = got.pipeline
    assert p.get_state() == PipelineState.FINAL_GLOBAL_RELAX and p._edges_version == 1 == ref.pipeline._edges_version
    assert p._relax_plan is None  # the next state builds anew
    want, have, before = _edge_inliers(ref.pipeline), _edge_inliers(p), _edge_inliers(entry)
    assert have.keys() == want.keys() == before.keys()
    changed = 0
    for k in want:
        np.testing.assert_array_equal(have[k].inlier_match_index, want[k].inlier_match_index, err_msg=str(k))
        np.testing.assert_array_equal(have[k].inlier_idx1, want[k].inlier_idx1)
        np.testing.assert_array_equal(have[k].inlier_idx2, want[k].inlier_idx2)
        np.testing.assert_allclose(have[k].ransac_relation, want[k].ransac_relation, rtol=0, atol=1e-6)
        np.testing.assert_allclose(have[k].rel_scores, want[k].rel_scores, rtol=0, atol=1e-9)
        assert np.isfinite(have[k].ransac_relation).all() or len(have[k].inlier_idx1) == 0
        changed += not np.array_equal(have[k].ransac_relation, before[k].ransac_relation)
    assert changed == len(want)  # every edge was fitted again with the new model
    # the store holds the calibrated FORWARD model, float64 on the host
    m = p.model_store[1]
    assert m.tag == "forward" and m.dtype == torch.float64 and m.focal_length_pixels.device.type == "cpu"


def test_focal_recovered(single):
    """From a tag 5 % off, the state recovers the focal within the JAX
    package's bound, and strictly improves on the tag."""
    _, got = single
    focal = got.log[-1]["focal"]
    rel = abs(focal - TRUE_FOCAL) / TRUE_FOCAL
    print(f"focal {focal:.3f} against {TRUE_FOCAL} (tag {TAG_FOCAL}): {100 * rel:.2f} %")
    assert rel < FOCAL_BOUND and rel < 0.6 * (TAG_FOCAL / TRUE_FOCAL - 1.0)
    assert abs(got.log[-1]["radial"][0]) < 0.05  # the truth has no distortion
