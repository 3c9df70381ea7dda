"""Kernel: the matching kernel's share of its roofline in the profiled slice,
in percent: the least time its launches could take on the H100 (each
launch's [P, N1, N2] counted by ``ocbench.counts``) over its device time."""
from ocbench.counts import hamming_top2_bound


def read(record):
    sl = record.get("slice") or {}
    launches, device_s = sl.get("hamming_launches"), sl.get("hamming_device_s")
    if not launches or not device_s:
        return None
    return 100.0 * sum(hamming_top2_bound(*shape)[0] for shape in launches) / device_s
