"""LM solver: deliberate host reads of a device flag an LM step (``lm host
reads``: each read of ``done`` and each CG stop check; implicit syncs are
not counted)."""
from ocbench.metrics._counters import event, ratio


def read(record):
    return ratio(event(record, "lm host reads"), event(record, "lm steps"))
