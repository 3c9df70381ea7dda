"""LM solver: host ms an LM step spends in its linear solve (``lm: linear
solve``: PCG or the dense solve, with the preconditioner)."""
from ocbench.metrics._counters import event, ratio, timer


def read(record):
    return ratio(timer(record, "lm: linear solve"), event(record, "lm steps"), 1e3)
