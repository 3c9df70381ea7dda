"""The LM's performance spans and counts (``relax/lm.py``, the shared loop of
``parallel/group_solver.py``) and the model-fit counts of ``ops/distort.py``,
on small problems: ``lm steps`` equals the iterations of ``solve``, the
lockstep turns of a batched solve and the shared loop's iterations; ``lm host
reads`` is steps + 1 on the Cholesky route; each step has its spans; the
solutions are bit-identical with the counters on and off; a repeated model
fit counts as a repeat within one job only."""

import dataclasses

import pytest
import torch

from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops import quaternion as Q
from opencalibration_tpu_torch.parallel import group_solver as GS
from opencalibration_tpu_torch.parallel.mesh import map_tree
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.utils import performance as perf
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

DOWN = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
STEP_SPANS = ("lm: linearize", "lm: linear solve", "lm: evaluate")
FAST = dict(init_lambda=1e-3, parameter_tolerance=1e-6)  # a few steps on the Cholesky route


@pytest.fixture(autouse=True)
def counters():
    perf.reset_performance_counters()
    perf.enable_performance_counters(True)
    yield
    perf.enable_performance_counters(False)
    perf.reset_performance_counters()


def _problem(seed=0, rows=2, cols=3):
    """Cameras on a grid looking down, each edge with four candidate relative
    poses (slot 0 the noisy truth): params near the truth, blocks, layout,
    free mask."""
    g = torch.Generator().manual_seed(seed)
    C = rows * cols
    pos = torch.tensor([[12.0 * c, 12.0 * r, 60.0] for r in range(rows) for c in range(cols)], dtype=torch.float64)
    tilt = Q.quat_from_axis_angle(torch.randn(C, 3, generator=g, dtype=torch.float64),
                                  0.05 * torch.rand(C, generator=g, dtype=torch.float64))
    quats = Q.quat_multiply(tilt, DOWN.expand(C, 4))
    edges = [(i, j) for i in range(C) for j in range(i + 1, C) if torch.dist(pos[i], pos[j]) < 13.0]
    pa = torch.tensor([e[0] for e in edges])
    pb = torch.tensor([e[1] for e in edges])
    P = len(edges)
    true_q = Q.quat_multiply(quats[pb], Q.quat_conjugate(quats[pa]))
    tdir = (pos[pb] - pos[pa]) / torch.linalg.norm(pos[pb] - pos[pa], dim=-1, keepdim=True)
    true_t = Q.quat_rotate_inverse(quats[pa], tdir)
    noise = torch.tensor([0.0, 0.6, 0.6, 0.6], dtype=torch.float64)[None, :, None]
    rel_q = Q.quat_boxplus(true_q[:, None].expand(P, 4, 4),
                           noise * torch.randn(P, 4, 3, generator=g, dtype=torch.float64))
    rel_t = true_t[:, None] + noise * torch.randn(P, 4, 3, generator=g, dtype=torch.float64)
    scores = torch.sort(5 + 195 * torch.rand(P, 4, generator=g, dtype=torch.float64), descending=True).values
    layout = TangentLayout(C, 0, 0, 1)
    blocks = (
        B.decomposed_rotation_block(layout, pa, pb, rel_q, rel_t, scores, scores > 0.25 * scores[:, :1],
                                    torch.ones(P, dtype=torch.float64)),
        B.downwards_prior_block(layout, torch.arange(C), torch.ones(C, dtype=torch.float64)),
    )
    start = Q.quat_boxplus(quats, 0.05 * torch.randn(C, 3, generator=g, dtype=torch.float64))
    params = RelaxParams.create(start, pos, dtype=torch.float64)
    return params, blocks, layout, layout.build_free_mask(device="cpu")


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _events():
    return {k: perf.get_event_count(k) for k in ("lm steps", "lm host reads")}


def _span_counts():
    return {k: sum(s.name == k for s in perf.spans()) for k in ("lm: solve", "lm: stop read") + STEP_SPANS}


@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
def test_lm_steps_of_solve_are_its_iterations(problem, linear_solver):
    params, blocks, layout, free = problem
    _, info = lm.solve(params, blocks, layout, free, max_iterations=50, linear_solver=linear_solver, **FAST)
    steps = int(info.iterations)
    assert 2 < steps < 50
    ev = _events()
    assert ev["lm steps"] == steps
    if linear_solver == "cholesky":
        # one read of ``done`` before each step and the read that stops
        assert ev["lm host reads"] == steps + 1
    else:  # the CG checks come on top
        assert ev["lm host reads"] >= steps + 1
    assert _span_counts() == {"lm: solve": 1, "lm: stop read": steps + 1, **{k: steps for k in STEP_SPANS}}
    by_id = {s.id: s for s in perf.spans()}
    (solve,) = [s for s in by_id.values() if s.name == "lm: solve"]
    assert all(s.parent == solve.id for s in by_id.values() if s.name != "lm: solve")


def test_host_reads_at_max_iterations(problem):
    params, blocks, layout, free = problem
    _, info = lm.solve(params, blocks, layout, free, max_iterations=2, linear_solver="cholesky", **FAST)
    assert int(info.iterations) == 2
    # the loop's bound ends it before a third read
    assert _events() == {"lm steps": 2.0, "lm host reads": 2.0}


def _two_lanes(problem):
    """The problem twice over a lane axis, lane 1 starting near its answer."""
    params, blocks, layout, free = problem
    solved, _ = lm.solve(params, blocks, layout, free, max_iterations=3, **FAST)
    stack = lambda a, b: torch.stack([a, b])  # noqa: E731
    lanes = RelaxParams(**{f: stack(getattr(params, f), getattr(solved, f)) for f in FIELDS})
    return lanes, tuple(map_tree(lambda x: stack(x, x), b) for b in blocks), layout, stack(free, free)


@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
def test_lm_steps_of_a_batch_are_its_lockstep_turns(problem, linear_solver):
    params, blocks, layout, free = _two_lanes(problem)
    perf.reset_performance_counters()
    _, info = lm.solve_batch(params, blocks, layout, free, max_iterations=50, linear_solver=linear_solver, **FAST)
    lanes = info.iterations.tolist()
    assert lanes[0] != lanes[1]  # the lanes stop at different steps
    ev = _events()
    assert ev["lm steps"] == max(lanes)
    if linear_solver == "cholesky":
        assert ev["lm host reads"] == max(lanes) + 1
    assert _span_counts() == {"lm: solve": 1, "lm: stop read": max(lanes) + 1,
                              **{k: max(lanes) for k in STEP_SPANS}}


def test_lm_steps_of_two_shards_in_lockstep(problem):
    params, blocks, layout, free = _two_lanes(problem)
    perf.reset_performance_counters()
    shards = [(GS._lanes(params, g, g + 1), tuple(GS._lanes(b, g, g + 1) for b in blocks), free[g:g + 1], 1e-3)
              for g in range(2)]
    outs = lm.solve_batch_shards(shards, layout, max_iterations=50, parameter_tolerance=1e-6,
                                 linear_solver="cholesky")
    lanes = [int(info.iterations) for _, info in outs]
    assert lanes[0] != lanes[1]
    # one step and one read a turn, however many shards run in it
    assert _events() == {"lm steps": max(lanes), "lm host reads": max(lanes) + 1}


def test_lm_steps_of_the_shared_loop(problem):
    params, blocks, layout, free = _two_lanes(problem)
    perf.reset_performance_counters()
    _, info, _ = GS._solve_shared(params, blocks, free, layout, 50, init_lam_s=1e-3, parameter_tolerance=1e-6)
    steps = int(info.iterations)
    assert 1 < steps < 50
    assert _events() == {"lm steps": steps, "lm host reads": steps + 1}
    assert _span_counts() == {"lm: solve": 1, "lm: stop read": steps + 1, **{k: steps for k in STEP_SPANS}}


SOLVES = {
    "solve_cholesky": lambda p, lanes: lm.solve(*p, linear_solver="cholesky", **FAST),
    "solve_cg_block": lambda p, lanes: lm.solve(*p, linear_solver="cg", cg_precond="block", **FAST),
    "solve_batch_cg": lambda p, lanes: lm.solve_batch(*lanes, linear_solver="cg", **FAST),
    "shared": lambda p, lanes: GS._solve_shared(lanes[0], lanes[1], lanes[3], lanes[2], 50, init_lam_s=1e-3,
                                                parameter_tolerance=1e-6)[:2],
}


@pytest.mark.parametrize("route", sorted(SOLVES))
def test_solutions_are_bit_identical_with_the_counters_on_and_off(problem, route):
    lanes = _two_lanes(problem)
    perf.enable_performance_counters(False)
    p_off, i_off = SOLVES[route](problem, lanes)
    perf.enable_performance_counters(True)
    perf.reset_performance_counters()
    p_on, i_on = SOLVES[route](problem, lanes)
    assert perf.get_event_count("lm steps") > 0 and perf.spans()
    for f in FIELDS:
        assert torch.equal(getattr(p_off, f), getattr(p_on, f))
    for f in dataclasses.fields(lm.SolveInfo):
        assert torch.equal(torch.as_tensor(getattr(i_off, f.name)), torch.as_tensor(getattr(i_on, f.name)))


def _model(focal=2000.0, k1=-0.05):
    return CameraModel.create(focal_length_pixels=focal, principal_point=[80.0, 60.0],
                              radial_distortion=[k1, 0.01, 0.0], tangential_distortion=[0.001, 0.0],
                              pixels_cols=160.0, pixels_rows=120.0, dtype=torch.float64, device="cpu")


def test_model_fit_repeats_count_within_one_job():
    perf.begin_job()
    inv = D.convert_to_inverse(_model())
    again = D.convert_to_inverse(_model())
    assert torch.equal(inv.radial_distortion, again.radial_distortion)
    assert perf.get_event_count("model fits") == 2
    assert perf.get_event_count("model fit repeats") == 1
    # another model, and the other direction of the same values, are new
    D.convert_to_inverse(_model(k1=-0.04))
    D.convert_to_forward(_model().with_tag(inv.tag))
    assert perf.get_event_count("model fits") == 4
    assert perf.get_event_count("model fit repeats") == 1
    # a new job starts again
    perf.reset_performance_counters()
    perf.begin_job()
    D.convert_to_inverse(_model())
    assert perf.get_event_count("model fits") == 1
    assert perf.get_event_count("model fit repeats") == 0
    # with the counters off the fits are counted and nothing is read
    perf.enable_performance_counters(False)
    D.convert_to_inverse(_model())
    assert perf.get_event_count("model fits") == 2
    assert perf.get_event_count("model fit repeats") == 0
