"""Shared arithmetic of the readers of the program's own spans and event
counts (``utils/performance.py``): one quantity over another."""


def timer(record: dict, key: str):
    """Seconds of the program's spans ``key``; None where none ran."""
    return (record.get("timers") or {}).get(key)


def event(record: dict, key: str):
    """The program's event count ``key``; None where it counted none."""
    return (record.get("events") or {}).get(key)


def ratio(numerator, denominator, scale: float = 1.0):
    """``scale`` times ``numerator`` over ``denominator``; None where either
    is missing or the denominator is 0."""
    if numerator is None or not denominator:
        return None
    return scale * numerator / denominator
