"""Pipeline states: seconds a job in MESH_REFINEMENT."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["state MESH_REFINEMENT"], "jobs")
