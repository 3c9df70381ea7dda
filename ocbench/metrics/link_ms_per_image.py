"""Link stage: ms an image in `ip: link run` (candidate pairs matched and
RANSACed on the card, chunk by chunk)."""
from ocbench.metrics._scopes import per


def read(record):
    return per(record, ["ip: link run"], "images", 1e3)
