"""Problem builder: camera-model fits a job (``model fits``: each
forward-to-inverse or inverse-to-forward conversion)."""
from ocbench.metrics._counters import event, ratio


def read(record):
    return ratio(event(record, "model fits"), record.get("jobs"))
