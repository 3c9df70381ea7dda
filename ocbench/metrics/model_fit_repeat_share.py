"""Problem builder: the share of model fits, in percent, that repeat a fit of
the same model in the same direction earlier in the same job (``model fit
repeats`` over ``model fits``; a program that counts fits and has no repeat
reads 0)."""
from ocbench.metrics._counters import event


def read(record):
    fits = event(record, "model fits")
    if not fits:
        return None
    return 100.0 * (event(record, "model fit repeats") or 0.0) / fits
