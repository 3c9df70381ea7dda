"""The reader of the LM's CUDA-graph counter: the share of steps run from
replays, None on a record of a program that does not count them."""

import json
import os

import pytest

from ocbench import cell as C

NAME = "lm_graph_step_share.calibrate"


@pytest.mark.parametrize("events, expected", [
    ({"lm steps": 92.0, "lm graph steps": 92.0, "lm graph captures": 0.0}, 100.0),
    ({"lm steps": 92.0, "lm graph steps": 23.0, "lm graph captures": 2.0}, 25.0),
    ({"lm steps": 92.0}, None),  # a program without the graphs
    ({}, None),
])
def test_reader(events, expected):
    record = {"timers": {}, "counts": {}, "events": events, "lm": {}, "jobs": 2, "slice": None}
    got = C.metric_reader(NAME)(record)
    assert got == (None if expected is None else pytest.approx(expected))


def test_declared_for_the_calibrate_cell():
    with open(os.path.join(C.HERE, "..", "BENCHMARK.json")) as f:
        declared = {m["name"]: m for m in json.load(f)["per_layer"]}
    m = declared[NAME]
    assert m["workloads"] == ["calibrate.fixed1600"] and m["moves"] == "calibrate_s"
    assert (m["unit"], m["better"], m["source"], m["layer"]) == ("%", "higher", "program_counter", "LM solver")
