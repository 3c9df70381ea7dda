"""The readers of the program's own LM and model-fit spans and counts: each
on a recorded record, None on a record of a program that lacks the span or
counter, and a reader for every per-layer metric of ``BENCHMARK.json``."""

import json
import os

import pytest

from ocbench import cell as C

RECORD = {
    "timers": {"lm: solve": 9.2, "lm: linearize": 4.6, "lm: linear solve": 2.3, "lm: evaluate": 1.8,
               "relax solve": 11.0},
    "counts": {"lm: solve": 12},
    "events": {"lm steps": 92.0, "lm host reads": 138.0, "lm iterations": 184.0, "model fits": 14.0,
               "model fit repeats": 12.0},
    "lm": {"iterations": 92, "seconds": 10.0, "calls": 12},
    "jobs": 2, "slice": None,
}
EXPECTED = {
    "lm_steps.calibrate": 46.0,
    "lm_step_ms.calibrate": 100.0,
    "lm_linearize_ms_per_step.calibrate": 50.0,
    "lm_linear_solve_ms_per_step.calibrate": 25.0,
    "lm_host_reads_per_step.calibrate": 1.5,
    "model_fits.calibrate": 7.0,
    "model_fit_repeat_share.calibrate": 100.0 * 12 / 14,
}
# what a program without the LM's and the fits' spans and counters records
PARENT = {"timers": {"relax solve": 11.0}, "counts": {}, "events": {"lm iterations": 184.0},
          "lm": {"iterations": 92, "seconds": 10.0, "calls": 12}, "jobs": 2, "slice": None}


def _benchmark():
    with open(os.path.join(C.HERE, "..", "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert C.metric_reader(name)(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_returns_none_where_the_program_lacks_the_counter(name):
    read = C.metric_reader(name)
    assert read(PARENT) is None
    assert read({"timers": {}, "counts": {}, "lm": {}, "images": 0, "jobs": 0, "slice": None}) is None


def test_no_repeat_reads_zero():
    record = dict(RECORD, events={"model fits": 5.0})
    assert C.metric_reader("model_fit_repeat_share.calibrate")(record) == 0.0


def test_every_per_layer_metric_has_a_reader():
    for m in _benchmark()["per_layer"]:
        assert callable(C.metric_reader(m["name"])), m["name"]


def test_the_new_metrics_are_declared_for_the_calibrate_cell():
    declared = {m["name"]: m for m in _benchmark()["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        assert m["workloads"] == ["calibrate.fixed1600"] and m["moves"] == "calibrate_s"
        assert m["better"] == "lower"
        assert m["layer"] == ("problem builder" if name.startswith("model_") else "LM solver")
