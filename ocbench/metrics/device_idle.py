"""Device: the share of the profiled slice in which no kernel, copy or set ran
on the card, in percent."""


def read(record):
    sl = record.get("slice") or {}
    if not sl.get("window_s") or not sl.get("busy_s"):
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
