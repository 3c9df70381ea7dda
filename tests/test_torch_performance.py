"""The port's performance counters (``opencalibration_tpu_torch/utils/
performance.py``): spans with their parent, thread and job, the summary's
self time and event counts, nothing recorded while the counters are off, the
spans mirrored into PyTorch's profiler on its own clock, and the contract the
benchmark's ``ocbench/trace.py`` reads."""

import threading
import time

import pytest
import torch

from ocbench import trace as OT
from opencalibration_tpu_torch.utils import performance as perf
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def counters():
    perf.reset_performance_counters()
    perf.enable_performance_counters(True)
    yield
    perf.enable_performance_counters(False)
    perf.reset_performance_counters()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nested_spans_on_two_threads_record_parent_thread_and_job():
    job = perf.begin_job()
    started = threading.Event()
    go_on = threading.Event()

    def decode():
        with perf.PerformanceMeasure("t outer"):
            started.set()
            assert go_on.wait(10)
            with perf.PerformanceMeasure("t inner"):
                pass

    worker = threading.Thread(target=decode)
    with perf.PerformanceMeasure("outer"):
        worker.start()
        assert started.wait(10)
        with perf.PerformanceMeasure("inner"):
            go_on.set()
            worker.join(10)
            assert not worker.is_alive()
    later = perf.begin_job()
    with perf.PerformanceMeasure("after"):
        pass

    spans = _by_name(perf.spans())
    (outer,), (inner,), (t_outer,), (t_inner,), (after,) = (
        spans[k] for k in ("outer", "inner", "t outer", "t inner", "after"))
    # the parent is the innermost span open on the same thread, whatever
    # the other thread has open
    assert outer.parent is None and inner.parent == outer.id
    assert t_outer.parent is None and t_inner.parent == t_outer.id
    assert outer.thread == inner.thread == threading.get_ident()
    assert t_outer.thread == t_inner.thread != outer.thread
    assert {outer.job, inner.job, t_outer.job, t_inner.job} == {job}
    assert after.job == later != job
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert len({s.id for s in perf.spans()}) == 5


def test_a_thread_takes_the_job_current_when_its_span_began():
    first = perf.begin_job()
    ready, go_on = threading.Event(), threading.Event()

    def decode():
        ready.set()
        assert go_on.wait(10)
        with perf.PerformanceMeasure("decode"):
            pass

    worker = threading.Thread(target=decode)
    worker.start()
    assert ready.wait(10)
    second = perf.begin_job()
    go_on.set()
    worker.join(10)
    assert not worker.is_alive()
    assert first != second
    assert [s.job for s in perf.spans()] == [second]


def test_summary_self_time_wall_time_and_event_counts():
    ms = 1_000_000
    spans = [
        perf.Span(2, "inner", 10 * ms, 40 * ms, 1, 1, 1),
        perf.Span(3, "inner", 50 * ms, 60 * ms, 1, 1, 1),
        perf.Span(1, "outer", 0, 100 * ms, 1, None, 1),
        perf.Span(4, "outer", 20 * ms, 120 * ms, 2, None, 1),  # another thread, overlapping
    ]
    with perf._lock:
        perf._timeline.extend(spans)
        perf._totals.update({"outer": 0.2, "inner": 0.04})
        perf._counts.update({"outer": 2, "inner": 2})
    perf.add_event_count("lm steps", 3)
    perf.add_event_count("lm steps", 2)
    perf.add_event_count("model fit repeats", 0.5)
    lines = perf.total_performance_summary().splitlines()
    assert lines[0].split() == ["key", "system_s", "wall_s", "par", "self_s", "count"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:3]}
    # outer: 0.2 s on two threads over 0.12 s of wall time; its first span
    # has 0.04 s of children
    assert rows["outer"] == ["0.200", "0.120", "1.67", "0.160", "2"]
    assert rows["inner"] == ["0.040", "0.040", "1.00", "0.040", "2"]
    assert lines[3].split() == ["event", "count"]
    assert lines[4:] == [f"{'lm steps':40s} {5:10d}", f"{'model fit repeats':40s} {'0.5':>10s}"]


def test_summary_self_time_of_real_spans():
    with perf.PerformanceMeasure("outer"):
        time.sleep(0.02)
        with perf.PerformanceMeasure("inner"):
            time.sleep(0.03)
    rows = {ln.split()[0]: [float(x) for x in ln.split()[1:]] for ln in
            perf.total_performance_summary().splitlines()[1:3]}
    system, _, _, self_s, count = rows["outer"]
    assert count == 1 and system >= 0.05
    assert 0.02 <= self_s + 1e-3 and self_s <= system - 0.03 + 1e-3
    assert rows["inner"][3] == rows["inner"][0]  # no children


class _NoLock:
    def __enter__(self):
        raise AssertionError("a span took the lock")

    def __exit__(self, *exc):
        return False


def test_nothing_is_recorded_and_no_lock_taken_while_the_counters_are_off(monkeypatch):
    perf.enable_performance_counters(False)
    monkeypatch.setattr(perf, "_lock", _NoLock())
    with perf.PerformanceMeasure("outer") as m:
        with perf.PerformanceMeasure("inner"):
            pass
        m.reset("renamed")
    assert m._id is None and m._rf is None
    assert not perf._totals and not perf._counts and not perf._timeline
    assert perf._stack() == []
    monkeypatch.undo()
    assert perf.total_performance_summary() == "(performance counters disabled or empty)"


def _profile(fn):
    """Run ``fn`` under torch.profiler on the CPU; its user annotations
    [(name, start_ns, end_ns)] and their thread ids."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events]


@pytest.mark.parametrize("counting", [True, False], ids=["counters_on", "counters_off"])
def test_spans_appear_in_the_profiler_on_its_clock_without_a_patch(counting):
    perf.enable_performance_counters(counting)
    assert perf.PerformanceMeasure.__enter__ is vars(perf.PerformanceMeasure)["__enter__"]

    def work():
        with perf.PerformanceMeasure("outer"):
            with perf.PerformanceMeasure("inner"):
                torch.ones(4).sum()
            with perf.PerformanceMeasure("second") as m:
                m.reset("second renamed")

    ann = {name: (s, e) for name, s, e in _profile(work)}
    assert {"outer", "inner", "second", "second renamed"} <= set(ann)
    (os_, oe), (is_, ie) = ann["outer"], ann["inner"]
    assert os_ <= is_ <= ie <= oe
    assert ann["second"][1] <= ann["second renamed"][0] <= ann["second renamed"][1] <= oe
    if counting:
        # the timeline's stamps are the profiler's clock
        mine = {s.name: s for s in perf.spans()}
        for name in ("outer", "inner"):
            assert abs(mine[name].start - ann[name][0]) < 5_000_000
            assert abs(mine[name].end - ann[name][1]) < 5_000_000
    else:
        assert perf.spans() == []


def test_the_benchmark_reads_the_module():
    OT.counters_on()
    with perf.PerformanceMeasure("lm: solve"):
        perf.add_event_count("lm steps", 1)
    snap = OT.counters_snapshot()
    assert set(snap) == {"timers", "counts", "events"}
    assert snap["counts"] == {"lm: solve": 1} and snap["events"] == {"lm steps": 1.0}
    assert snap["timers"]["lm: solve"] > 0

    def work():
        with OT._scopes_as_annotations():
            with perf.PerformanceMeasure("state X"):
                with perf.PerformanceMeasure("lm: solve"):
                    pass
        assert perf.PerformanceMeasure.__enter__ is vars(perf.PerformanceMeasure)["__enter__"]

    ann = sorted(_profile(work), key=lambda a: (a[1], -a[2]))
    # the benchmark's patch and the program's mirror both annotate each
    # scope, nested under the same name, the patch's outside
    assert [a[0] for a in ann] == ["state X", "state X", "lm: solve", "lm: solve"]
    for outer, inner in ((ann[0], ann[1]), (ann[2], ann[3]), (ann[1], ann[2])):
        assert outer[1] <= inner[1] <= inner[2] <= outer[2]


class _Ev:
    """A kineto event's methods, as ``reduce_events`` reads them."""

    def __init__(self, name, start_us, dur_us, cuda=False, annotation=False, tid=1):
        self._n, self._s, self._d, self._c, self._a, self._t = name, start_us, dur_us, cuda, annotation, tid

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t


def test_idle_labels_are_the_same_when_each_scope_is_annotated_twice():
    scopes = [("state FINAL_GLOBAL_RELAX", 0, 200), ("relax solve", 10, 180), ("lm: solve", 20, 170),
              ("lm: linearize", 30, 40), ("lm: linear solve", 72, 30), ("lm: evaluate", 104, 40),
              ("lm: stop read", 146, 4), ("jpeg: decode", 0, 200)]
    kernels = [_Ev("k", t, 2, cuda=True) for t in (5, 25, 35, 69, 80, 101, 110, 150, 160, 190)]

    def annotations(twice):
        out = []
        for name, s, d in scopes:
            tid = 2 if name.startswith("jpeg") else 1
            out.append(_Ev(name, s, d, annotation=True, tid=tid))
            if twice:  # the mirror opens a little later and closes a little earlier
                out.append(_Ev(name, s + 0.1, d - 0.2, annotation=True, tid=tid))
        return out

    once = OT.reduce_events(annotations(False) + kernels)
    twice = OT.reduce_events(annotations(True) + kernels)
    assert twice == once
    labels = dict(once["idle_gaps"])
    assert {"lm: linearize", "lm: linear solve", "lm: evaluate", "lm: solve", "relax solve"} <= set(labels)
