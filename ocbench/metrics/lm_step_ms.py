"""LM solver: ms an LM step, the program's ``lm: solve`` spans over its ``lm
steps`` (no synchronise at the solve's end: the last read of ``done`` waits
for the last step)."""
from ocbench.metrics._counters import event, ratio, timer


def read(record):
    return ratio(timer(record, "lm: solve"), event(record, "lm steps"), 1e3)
