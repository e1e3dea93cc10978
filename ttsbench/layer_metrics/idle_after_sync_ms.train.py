"""device: the device's idle gaps in the traced window that hold the end of
one of the program's ``train.sync.*`` spans (the device drained while the
host waited, and waits for the host's next launch), summed, mean per step,
in ms."""

from bisect import bisect_left

from ttsbench import program_spans
from ttsbench.harness import gaps


def read(run):
    if not run.units or not run.device:
        return None
    found = program_spans.spans(run)
    if not found or "train.step" not in found:
        return None
    ends = sorted(s.end for name in program_spans.named(found, "train.sync.")
                  for s in found[name])
    idle = 0
    for lo, hi in gaps([(s, e) for s, e, _ in run.device], run.lo, run.hi):
        i = bisect_left(ends, lo)
        if i < len(ends) and ends[i] <= hi:
            idle += hi - lo
    return idle / 1e6 / run.units
