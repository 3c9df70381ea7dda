"""Pipeline states: seconds a job in FINAL_GLOBAL_RELAX."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["state FINAL_GLOBAL_RELAX"], "jobs")
