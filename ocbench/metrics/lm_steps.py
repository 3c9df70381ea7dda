"""LM solver: LM steps a job, as the program counts them (``lm steps``: one a
loop turn, a lockstep turn of lanes or shards once)."""
from ocbench.metrics._counters import event, ratio


def read(record):
    return ratio(event(record, "lm steps"), record.get("jobs"))
