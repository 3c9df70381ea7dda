"""Load stage: ms an image that the pipeline waits in `ip: load finish` (the
decode threads joined, the batch extracted on the card)."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["ip: load finish"], "images", 1e3)
