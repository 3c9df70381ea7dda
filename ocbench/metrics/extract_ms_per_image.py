"""Load stage: ms an image in `load: extract device` (the batch's features
extracted on the card)."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["load: extract device"], "images", 1e3)
