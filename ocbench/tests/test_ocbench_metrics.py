"""Each per-layer reader on a recorded record, and the slice's reduction."""

import json
import os

import pytest
import torch

from ocbench import cell as C
from ocbench import counts
from ocbench.trace import reduce_events

RECORD = {
    "timers": {"ip: load finish": 1.5, "ip: link run": 8.0, "ip: relax dispatch": 6.0, "ip: relax run": 9.0,
               "jpeg: decode": 12.0, "load: extract device": 2.5, "build: model inversion": 2.0,
               "refresh: model inversion": 1.0, "writeback: model conversion": 0.5, "state MESH_REFINEMENT": 7.0,
               "state FINAL_GLOBAL_RELAX": 8.0, "lm: solve": 3.2, "lm: linearize": 0.8, "lm: linear solve": 0.4},
    "counts": {"jpeg: decode": 120},
    "events": {"lm steps": 400.0, "lm host reads": 450.0, "lm graph steps": 300.0, "model fits": 12.0,
               "model fit repeats": 9.0},
    "lm": {"iterations": 200, "seconds": 14.0, "calls": 30},
    "images": 100, "jobs": 2, "batches": 4,
    "slice": {"busy_s": 1.0, "window_s": 8.0, "hamming_device_s": 2 * 40e-6,
              "hamming_launches": [(16, 1024, 1024), (16, 1024, 1024)]},
}
EXPECTED = {
    "load_wait_ms_per_image.ingest": 15.0,
    "jpeg_decode_ms.ingest": 100.0,
    "extract_ms_per_image.ingest": 25.0,
    "link_ms_per_image.ingest": 80.0,
    "ip_relax_ms_per_image.ingest": 150.0,
    "model_inversion_ms_per_image.ingest": 35.0,
    "model_inversion_s.calibrate": 1.75,
    "mesh_refinement_s.calibrate": 3.5,
    "final_relax_s.calibrate": 4.0,
    "lm_ms_per_iter.calibrate": 70.0,
    "lm_iters.calibrate": 100.0,
    "lm_steps.calibrate": 200.0,
    "lm_steps.ingest": 100.0,
    "lm_step_ms.calibrate": 8.0,
    "lm_step_ms.ingest": 8.0,
    "lm_linearize_ms_per_step.calibrate": 2.0,
    "lm_linear_solve_ms_per_step.calibrate": 1.0,
    "lm_host_reads_per_step.calibrate": 1.125,
    "lm_graph_step_share.calibrate": 75.0,
    "model_fits.calibrate": 6.0,
    "model_fit_repeat_share.calibrate": 75.0,
    "hamming_top2_roofline.ingest": 100.0 * counts.hamming_top2_bound(16, 1024, 1024)[0] / 40e-6,
    "hamming_top2_roofline.calibrate": 100.0 * counts.hamming_top2_bound(16, 1024, 1024)[0] / 40e-6,
    "device_idle.ingest": 87.5,
    "device_idle.calibrate": 87.5,
}


def per_layer_names():
    with open(os.path.join(C.HERE, "..", "BENCHMARK.json")) as f:
        return [m["name"] for m in json.load(f)["per_layer"]]


def test_every_metric_of_the_benchmark_is_covered_here():
    # the .ingest cases are the readers of the ingest cell that waits (PERF.md, Open questions)
    assert set(per_layer_names()) <= set(EXPECTED)
    assert {m for m in EXPECTED if m.endswith(".calibrate")} <= set(per_layer_names())


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert C.metric_reader(name)(RECORD) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    empty = {"timers": {}, "counts": {}, "events": {}, "lm": {}, "images": 0, "jobs": 0, "batches": 0, "slice": None}
    assert C.metric_reader(name)(empty) is None


class Ev:
    """A kineto event's methods, as ``reduce_events`` reads them."""

    def __init__(self, name, start_us, dur_us, cuda=False, annotation=False, tid=1):
        self._n, self._s, self._d, self._c, self._a, self._t = name, start_us, dur_us, cuda, annotation, tid

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._d * 1000

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t


def test_slice_reduction():
    events = [
        Ev("state INITIAL_PROCESSING", 0, 100, annotation=True),
        Ev("ip: link run", 10, 30, annotation=True),
        Ev("ip: relax run", 50, 50, annotation=True),
        Ev("jpeg: decode", 0, 100, annotation=True, tid=2),
        Ev("hamming_top2_kernel", 12, 5, cuda=True),
        Ev("gemm", 15, 5, cuda=True),  # overlaps the kernel before it
        Ev("gemm", 60, 10, cuda=True),
        Ev("aten::mm", 58, 1),
        Ev("ip: relax run", 55, 40, cuda=True, annotation=True),  # the scope's span on the device
    ]
    out = reduce_events(events)
    assert out["busy_s"] == pytest.approx(18e-6)
    assert out["hamming_device_s"] == pytest.approx(5e-6)
    assert dict(out["device_ops"]) == pytest.approx({"hamming_top2_kernel": 5e-6, "gemm": 15e-6})
    # one gap, 20 -> 60 us, whose middle (40) is in the state scope alone
    assert dict(out["idle_gaps"]) == pytest.approx({"state INITIAL_PROCESSING": 40e-6})
