"""Relax stage in INITIAL_PROCESSING: ms an image in `ip: relax dispatch` (the
problems built) and `ip: relax run` (solved and written back)."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["ip: relax dispatch", "ip: relax run"], "images", 1e3)
