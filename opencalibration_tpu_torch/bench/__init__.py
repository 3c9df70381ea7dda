"""The port's benchmark entry points, twins of the repository's root scripts:
``bench`` (``bench.py``: the calibration step and a 24-image end-to-end run,
one JSON line), ``bench_e2e`` (``bench_e2e.py``: the pipeline at survey
scale, with a checkpoint resume) and ``bench_scale`` (``bench_scale.py``:
the calibration step over survey sizes)."""
