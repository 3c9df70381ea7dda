"""LM solver: host ms an LM step spends linearising (``lm: linearize``: the
per-instance quadratics or the normal equations, gradient and diagonal)."""
from ocbench.metrics._counters import event, ratio, timer


def read(record):
    return ratio(timer(record, "lm: linearize"), event(record, "lm steps"), 1e3)
