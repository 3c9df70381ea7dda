"""Load stage: ms of one JPEG decode (`jpeg: decode`, on the decode threads)."""


def read(record):
    timers, counts = record.get("timers") or {}, record.get("counts") or {}
    if not counts.get("jpeg: decode"):
        return None
    return 1e3 * timers["jpeg: decode"] / counts["jpeg: decode"]
