"""LM solver: the share of LM steps whose linearisation and evaluation ran
from replayed CUDA graphs (``lm graph steps`` over ``lm steps``), in %."""
from ocbench.metrics._counters import event, ratio


def read(record):
    return ratio(event(record, "lm graph steps"), event(record, "lm steps"), 100.0)
