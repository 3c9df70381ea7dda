"""The port's benchmark entry points, twins of the repository's root scripts:
``bench`` (``bench.py``: the calibration step and a 24-image end-to-end run,
one JSON line), ``bench_e2e`` (``bench_e2e.py``: the pipeline at survey
scale, with a checkpoint resume), ``bench_scale`` (``bench_scale.py``: the
calibration step over survey sizes), ``bench_kernels`` (``bench_kernels.py``:
the hot functions and the Hamming top-2 kernel beside the H100's rooflines),
``bench_lm_solvers`` (``bench_lm_solvers.py``: ms per LM iteration of the
dense and matrix-free solvers by tangent dimension), ``bench_extract_profile``
(``bench_extract_profile.py``: the extraction's stages), ``bench_overlap_ab``
(``bench_overlap_ab.py``: INITIAL_PROCESSING with and without the host /
device overlap) and ``bench_fed_ab`` (``bench_fed_ab.py``: the ``fed`` and
Gaussian scale spaces on the bench workload). Each runs on the card unless
the caller asks for the CPU."""
