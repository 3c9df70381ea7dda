"""LM solver: LM steps a batch of the window, as the program counts them (``lm
steps``: one a loop turn, a lockstep turn of the relax's lanes once)."""
from ocbench.metrics._counters import event, ratio


def read(record):
    return ratio(event(record, "lm steps"), record.get("batches"))
