"""Performance counters.

Re-implements the reference's RAII scope timers + parallelism-aware
summary (reference src/performance/performance.cpp:44-170,
performance.hpp:9-36): per-key totals plus a begin/end timeline; the
summary replays the timeline counting concurrent measures to report
system time, wall time and effective parallelism per key.

Copy of opencalibration_tpu/utils/performance.py without its XLA compile
listener; the keys are the same, so both pipelines report under the same
names.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

_enabled = False
_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_timeline: List[Tuple[float, bool, str]] = []  # (t, is_begin, key)


def enable_performance_counters(enabled: bool = True):
    global _enabled
    _enabled = enabled


def reset_performance_counters():
    with _lock:
        _totals.clear()
        _counts.clear()
        _timeline.clear()
        _events.clear()


# -- event counters (not timers): e.g. LM iterations executed, residual
# blocks solved — the quantities per-second benchmarks are built from
_events: Dict[str, float] = defaultdict(float)


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


def get_timer_count(key: str) -> int:
    """How many scopes of one key were measured (0 if never measured)."""
    with _lock:
        return _counts.get(key, 0)


class PerformanceMeasure:
    """Context-manager scope timer (RAII equivalent). Supports reset() to
    re-key mid-scope like the reference's PerformanceMeasure::reset."""

    def __init__(self, key: str):
        self._key = key
        self._start = time.perf_counter() if _enabled else 0.0
        if _enabled:
            with _lock:
                _timeline.append((self._start, True, key))

    def reset(self, new_key: str):
        if not _enabled:
            self._key = new_key
            return
        self._finish()
        self._key = new_key
        self._start = time.perf_counter()
        with _lock:
            _timeline.append((self._start, True, new_key))

    def _finish(self):
        end = time.perf_counter()
        with _lock:
            _totals[self._key] += end - self._start
            _counts[self._key] += 1
            _timeline.append((end, False, self._key))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if _enabled:
            self._finish()
        return False


def total_performance_summary() -> str:
    """System time, wall time, and effective parallelism per key
    (reference performance.cpp:101-170)."""
    with _lock:
        if not _timeline and not _totals:
            return "(performance counters disabled or empty)"
        events = sorted(_timeline)
        keys = sorted(_totals.keys())
        wall: Dict[str, float] = defaultdict(float)
        active: Dict[str, int] = defaultdict(int)
        last_t = events[0][0] if events else 0.0
        for t, is_begin, key in events:
            for k, n in active.items():
                if n > 0:
                    wall[k] += t - last_t
            last_t = t
            active[key] += 1 if is_begin else -1
        lines = [f"{'key':40s} {'system_s':>10s} {'wall_s':>10s} {'par':>6s} {'count':>7s}"]
        for k in keys:
            w = wall[k]
            par = _totals[k] / w if w > 0 else 1.0
            lines.append(
                f"{k:40s} {_totals[k]:10.3f} {w:10.3f} {par:6.2f} {_counts[k]:7d}"
            )
        return "\n".join(lines)
