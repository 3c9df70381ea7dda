"""Performance counters: spans and event counts.

Re-implements the reference's RAII scope timers + parallelism-aware
summary (reference src/performance/performance.cpp:44-170,
performance.hpp:9-36): per-key totals plus the finished spans; the summary
reports system time, wall time, effective parallelism and self time per key.
The keys are the JAX package's, so both pipelines report under the same
names. Beyond the reference:

* each span records its thread, its parent (the innermost span open on the
  same thread when it began) and its job (``begin_job``: ``Pipeline`` starts
  one per pipeline; a span on a decode thread takes the job current when it
  began);
* spans are stamped with ``time.time_ns()``, the clock PyTorch's profiler
  stamps its events with;
* while PyTorch's profiler records, each span also opens a
  ``record_function`` of its own name, so the program's spans lie around
  the kernels they launched in the profiler's trace. The program never
  starts a profiler itself.

With the counters off and no profiler recording, a span takes no lock and
records nothing. Event counts (``add_event_count``) are always on.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

_enabled = False
_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
# -- event counters (not timers): e.g. LM steps taken, host reads, model
# fits — the quantities per-second benchmarks are built from
_events: Dict[str, float] = defaultdict(float)
_timeline: List["Span"] = []  # finished spans, in the order they ended
_open = threading.local()  # ``stack``: this thread's recorded open spans, innermost last
_span_ids = itertools.count(1)
_job_ids = itertools.count(1)
_job = 0  # the current job
_job_marks: set = set()  # ``repeat_in_job``'s keys of the current job
# true while a profiler records, also one enabled without torch.profiler's
# Python wrapper (whose ``_is_profiler_enabled`` flag stays false then)
_profiler_on = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """A finished span. ``start`` and ``end`` are ``time.time_ns()``;
    ``parent`` is the id of the innermost span open on the same thread when
    it began (None at the thread's top)."""

    id: int
    name: str
    start: int
    end: int
    thread: int
    parent: Optional[int]
    job: int


def enable_performance_counters(enabled: bool = True):
    global _enabled
    _enabled = enabled


def counters_enabled() -> bool:
    return _enabled


def reset_performance_counters():
    with _lock:
        _totals.clear()
        _counts.clear()
        _timeline.clear()
        _events.clear()


def begin_job() -> int:
    """Start a new job: later spans carry its id and ``repeat_in_job``
    starts afresh. Returns the id."""
    global _job
    with _lock:
        _job = next(_job_ids)
        _job_marks.clear()
        return _job


def repeat_in_job(key) -> bool:
    """Whether ``key`` was already marked in the current job; marks it."""
    with _lock:
        if key in _job_marks:
            return True
        _job_marks.add(key)
        return False


def add_event_count(key: str, n: float):
    """Always-on cheap accumulator (unlike the scope timers, these are
    gated by the caller, not by enable_performance_counters)."""
    with _lock:
        _events[key] += float(n)


def get_event_count(key: str) -> float:
    with _lock:
        return _events.get(key, 0.0)


def get_timer_total(key: str) -> float:
    """Accumulated scope-timer seconds for one key (0 if never measured)."""
    with _lock:
        return _totals.get(key, 0.0)


def spans() -> List[Span]:
    """The finished spans recorded since the last reset."""
    with _lock:
        return list(_timeline)


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class PerformanceMeasure:
    """Context-manager span (RAII equivalent), timed from ``__enter__`` to
    ``__exit__``. Supports reset() to re-key mid-scope like the reference's
    PerformanceMeasure::reset."""

    def __init__(self, key: str):
        self._key = key
        self._id = None  # set while the span is recorded
        self._rf = None  # the profiler's record_function while one is open

    def _begin(self):
        stack = _stack()
        self._parent = stack[-1]._id if stack else None
        self._job = _job
        self._id = next(_span_ids)
        stack.append(self)
        self._start = time.time_ns()

    def _finish(self):
        end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        span = Span(self._id, self._key, self._start, end, threading.get_ident(), self._parent, self._job)
        self._id = None
        with _lock:
            _totals[self._key] += (end - self._start) * 1e-9
            _counts[self._key] += 1
            _timeline.append(span)

    def reset(self, new_key: str):
        self.__exit__(None, None, None)
        self._key = new_key
        self.__enter__()

    def __enter__(self):
        if _enabled:
            self._begin()
        if _profiler_on():
            self._rf = torch.profiler.record_function(self._key)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        if self._id is not None:
            self._finish()
        return False


def _union_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def total_performance_summary() -> str:
    """Per key: system time (the spans' summed time), wall time (the union of
    the key's spans), effective parallelism, self time (the spans' time less
    what their child spans cover) and the count (reference
    performance.cpp:101-170); then the event counts."""
    with _lock:
        finished = list(_timeline)
        totals, counts, events = dict(_totals), dict(_counts), dict(_events)
    if not finished and not totals and not events:
        return "(performance counters disabled or empty)"
    covered: Dict[int, int] = defaultdict(int)
    intervals = defaultdict(list)
    for s in finished:
        if s.parent is not None:
            covered[s.parent] += s.end - s.start
        intervals[s.name].append((s.start, s.end))
    self_ns: Dict[str, int] = defaultdict(int)
    for s in finished:
        self_ns[s.name] += s.end - s.start - covered[s.id]
    lines = [f"{'key':40s} {'system_s':>10s} {'wall_s':>10s} {'par':>6s} {'self_s':>10s} {'count':>7s}"]
    for k in sorted(totals):
        w = _union_ns(intervals[k]) * 1e-9
        par = totals[k] / w if w > 0 else 1.0
        lines.append(f"{k:40s} {totals[k]:10.3f} {w:10.3f} {par:6.2f} {self_ns[k] * 1e-9:10.3f} {counts[k]:7d}")
    if events:
        lines.append(f"{'event':40s} {'count':>10s}")
        lines.extend(f"{k:40s} {events[k]:10.12g}" for k in sorted(events))
    return "\n".join(lines)
