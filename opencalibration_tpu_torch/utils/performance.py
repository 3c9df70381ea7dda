"""Scope timers and event counters of the pipeline: the JAX package's host
module ``opencalibration_tpu/utils/performance.py`` (numpy and threading
only), used as it is, so both pipelines report under the same keys."""

from opencalibration_tpu.utils.performance import (  # noqa: F401  (re-exported)
    PerformanceMeasure,
    add_event_count,
    enable_performance_counters,
    get_event_count,
    reset_performance_counters,
    total_performance_summary,
)
