"""Shared arithmetic of the readers: scope seconds over a count of work."""


def per(record: dict, keys, denominator: str, scale: float = 1.0):
    """Sum of the scopes ``keys`` over ``record[denominator]``, times
    ``scale``; None where no scope ran or nothing was counted."""
    timers = record.get("timers") or {}
    if not any(k in timers for k in keys) or not record.get(denominator):
        return None
    return scale * sum(timers.get(k, 0.0) for k in keys) / record[denominator]
