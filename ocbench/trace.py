"""What a traced run (``--trace 1``) reads, from the benchmark's side.

* The program's performance counters (``utils/performance.py``: host-clock
  scopes, event counts), switched on for the whole window and read as
  snapshots.
* ``LMLog``: LM iterations and seconds of every call to ``relax/lm.py``'s
  ``solve`` / ``solve_batch``, by wrapping the module's functions (the
  group solver calls them through the module).
* ``HammingLog``: the [P, N1, N2] of every launch of the matching kernel, by
  wrapping ``ops/hamming_cuda.hamming_top2`` (the matcher imports it at
  each call).
* ``Slice``: PyTorch's profiler over a bounded part of the window. It gives
  the device's busy seconds (the union of kernel, copy and set intervals),
  device time by operation, the matching kernel's device time, and the idle
  gaps between device operations, each labelled by the program's innermost
  open scope on the main thread (each scope is mirrored as a
  ``record_function`` while the slice runs). On the host it records those
  scopes alone, not every operator, and reads the raw events without
  building the profiler's tables: the LM launches thousands of operators an
  iteration, and recording and tabling each of them cost a traced run tens
  of seconds.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

HAMMING_KERNEL = "hamming_top2_kernel"
TOP = 10  # entries of each breakdown list


def _perf():
    from opencalibration_tpu_torch.utils import performance

    return performance


def counters_on():
    perf = _perf()
    perf.reset_performance_counters()
    perf.enable_performance_counters(True)


def counters_snapshot() -> dict:
    """Every scope's seconds and count and every event count so far. The
    module keeps them in its own dicts and has no call that lists the keys."""
    perf = _perf()
    with perf._lock:
        return {"timers": dict(perf._totals), "counts": dict(perf._counts), "events": dict(perf._events)}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Patch:
    """Replace ``module.name`` by ``wrap(original)`` while entered."""

    def __init__(self, module, name, wrap):
        self.module, self.name, self.wrap = module, name, wrap

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.wrap(self.orig))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class LMLog:
    """Totals of LM iterations (loop iterations: a batched solve's lanes run
    in lockstep) and host seconds to the solve's end, with a synchronise."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.iterations = 0
        self.seconds = 0.0
        self.calls = 0

    def _wrap(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync()
            self.seconds += time.perf_counter() - t0
            self.iterations += int(torch.as_tensor(out[1].iterations).max())
            self.calls += 1
            return out

        return timed

    def snapshot(self) -> dict:
        return {"iterations": self.iterations, "seconds": self.seconds, "calls": self.calls}

    @contextlib.contextmanager
    def installed(self):
        from opencalibration_tpu_torch.relax import lm

        with Patch(lm, "solve", self._wrap), Patch(lm, "solve_batch", self._wrap):
            yield self


class HammingLog:
    """[P, N1, N2] of each launch of the matching kernel, and whether it fell
    inside the profiled slice."""

    def __init__(self):
        self.launches = []
        self.in_slice = False

    def _wrap(self, fn):
        def recorded(packed1, packed2, valid2):
            p1, p2 = (packed1[None], packed2[None]) if packed1.dim() == 2 else (packed1, packed2)
            self.launches.append((int(p1.shape[0]), int(p1.shape[1]), int(p2.shape[1]), self.in_slice))
            return fn(packed1, packed2, valid2)

        # the kernel's wrapper counts its launches on the module's name
        recorded.launches = getattr(fn, "launches", 0)
        return recorded

    @contextlib.contextmanager
    def installed(self):
        from opencalibration_tpu_torch.ops import hamming_cuda

        with Patch(hamming_cuda, "hamming_top2", self._wrap):
            yield self


@contextlib.contextmanager
def _scopes_as_annotations():
    """Mirror every ``PerformanceMeasure`` scope as a ``record_function``."""
    cls = _perf().PerformanceMeasure
    enter, exit_ = cls.__enter__, cls.__exit__

    def patched_enter(self):
        self._ocbench_rf = torch.profiler.record_function(self._key)
        self._ocbench_rf.__enter__()
        return enter(self)

    def patched_exit(self, *exc):
        out = exit_(self, *exc)
        rf = self.__dict__.pop("_ocbench_rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)
        return out

    cls.__enter__, cls.__exit__ = patched_enter, patched_exit
    try:
        yield
    finally:
        cls.__enter__, cls.__exit__ = enter, exit_


def _ns(event, which: str) -> int:
    fn = getattr(event, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{which}_us")() * 1000)


def _dur_ns(event) -> int:
    fn = getattr(event, "duration_ns", None)
    return int(fn()) if fn is not None else int(event.duration_us() * 1000)


def _innermost_segments(annotations):
    """Piecewise labels [(start, end, label)] of nested annotations
    [(start, end, label)]: where several are open, the latest opened."""
    bounds = []
    for s, e, name in annotations:
        bounds.append((s, 1, e, name))
        bounds.append((e, 0, e, name))
    bounds.sort(key=lambda b: (b[0], b[1]))
    segs, stack, last = [], [], None
    for t, is_start, end, name in bounds:
        if stack and last is not None and t > last:
            segs.append((last, t, stack[-1][1]))
        if is_start:
            stack.append((end, name))
        else:
            for k in range(len(stack) - 1, -1, -1):
                if stack[k] == (end, name):
                    del stack[k]
                    break
        last = t
    return segs


def reduce_events(events, hamming_name: str = HAMMING_KERNEL) -> dict:
    """Device busy seconds, device seconds by operation name, the matching
    kernel's device seconds and idle seconds by host scope, from kineto
    events (the profiler's raw results, ``_disable_profiler().events()``) or
    any objects with the same methods. A traced job holds some 10^5 device
    events, so the loop makes few calls an event and the intervals are
    merged with numpy."""
    starts, durs, names, annotations = [], [], [], defaultdict(list)
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        if e.is_user_annotation():
            # a scope appears on the host's timeline and, as the span of the
            # kernels it launched, on the device's: only the host's is a scope
            if e.device_type() != cuda:
                s = _ns(e, "start")
                annotations[e.start_thread_id()].append((s, s + _dur_ns(e), e.name()))
        elif e.device_type() == cuda:
            d = _dur_ns(e)
            if d > 0:
                starts.append(_ns(e, "start"))
                durs.append(d)
                names.append(e.name())
    by_op = defaultdict(float)
    for name, d in zip(names, durs):
        by_op[name[:160]] += d * 1e-9
    hamming_s = sum(d for name, d in zip(names, durs) if hamming_name in name) * 1e-9
    # merged busy intervals: a new one starts where a start lies past the
    # furthest end so far
    order = np.argsort(np.asarray(starts, np.int64), kind="stable")
    s = np.asarray(starts, np.int64)[order]
    e = s + np.asarray(durs, np.int64)[order]
    reach = np.maximum.accumulate(e) if len(e) else e
    new = np.flatnonzero(s[1:] > reach[:-1]) + 1 if len(s) else s
    first = np.concatenate([[0], new]).astype(np.int64) if len(s) else new
    last_end = reach[np.concatenate([new - 1, [len(s) - 1]]).astype(np.int64)] if len(s) else reach
    busy_s = float((last_end - s[first]).sum()) * 1e-9
    gap_a, gap_b = last_end[:-1], s[first[1:]]
    # the main thread is the one that holds the pipeline's state scopes
    main = max(annotations, key=lambda t: sum(1 for a in annotations[t] if a[2].startswith("state ")),
               default=None)
    segs = _innermost_segments(annotations[main]) if main is not None else []
    seg_start = np.asarray([a for a, _, _ in segs], np.int64)
    seg_end = np.asarray([b for _, b, _ in segs], np.int64)
    mids = (gap_a + gap_b) // 2
    k = np.searchsorted(seg_start, mids, side="right") - 1
    inside = (k >= 0) & (seg_end[np.maximum(k, 0)] > mids) if len(segs) else np.zeros(len(mids), bool)
    idle = defaultdict(float)
    for kk, ok, gap in zip(k.tolist(), inside.tolist(), ((gap_b - gap_a) * 1e-9).tolist()):
        idle[segs[kk][2] if ok else "(no scope)"] += gap
    return {
        "busy_s": busy_s,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
        "hamming_device_s": hamming_s,
    }


class Slice:
    """``torch.profiler`` over one bounded part of the window (``with``);
    ``reduce`` reads its events once the window has closed."""

    def __init__(self, hamming: HammingLog):
        self.hamming = hamming
        self._prof = None

    def __enter__(self):
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState, _enable_profiler,
                                    _prepare_profiler)

        _sync()
        self._scopes = _scopes_as_annotations()
        self._scopes.__enter__()
        activities = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            activities.add(ProfilerActivity.CUDA)
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        self._results = None
        self.hamming.in_slice = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        _sync()
        self.window_s = time.perf_counter() - self._t0
        self.hamming.in_slice = False
        self._results = _disable_profiler()
        self._scopes.__exit__(*exc)
        self.launches = [ln[:3] for ln in self.hamming.launches if ln[3]]
        return False

    def reduce(self) -> dict:
        out = reduce_events(self._results.events())
        self._results = None
        return dict(out, window_s=self.window_s, hamming_launches=self.launches)


class Trace:
    """The traced run's recorders, or nothing at all when ``enabled`` is
    false (the untraced run measures the end-to-end metrics)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.lm = LMLog()
        self.hamming = HammingLog()
        self.slice = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.enabled:
            self._stack.enter_context(self.lm.installed())
            self._stack.enter_context(self.hamming.installed())
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def window_start(self):
        if self.enabled:
            counters_on()
            self.lm.reset()
            self.hamming.launches = []

    def profiled(self):
        """A context that profiles what runs inside it (once per run)."""
        if not self.enabled or self.slice is not None:
            return contextlib.nullcontext()
        self.slice = Slice(self.hamming)
        return self.slice

    def snapshot(self) -> dict:
        if not self.enabled:
            return {}
        return {**counters_snapshot(), "lm": self.lm.snapshot()}
