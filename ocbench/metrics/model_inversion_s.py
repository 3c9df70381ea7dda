"""Problem builder: seconds a job converting camera models between forward and
inverse form."""
from ocbench.metrics._scopes import per
from ocbench.metrics.model_inversion_ms_per_image import KEYS


def read(record):
    return per(record, KEYS, "jobs")
