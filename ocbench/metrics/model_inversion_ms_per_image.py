"""Problem builder: ms an image converting camera models between forward and
inverse form (`build: model inversion`, `refresh: model inversion`,
`writeback: model conversion`)."""
from ocbench.metrics._scopes import per

KEYS = ["build: model inversion", "refresh: model inversion", "writeback: model conversion"]


def read(record):
    return per(record, KEYS, "images", 1e3)
