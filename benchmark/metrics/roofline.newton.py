"""The Newton solves' least time at the cell's shapes (``work/newton.py``
against ``harness/peaks.py``) over the device time of the Newton kernel's
functions in the traced window (the union of their intervals), in %."""

from harness.peaks import least_seconds

KERNEL = "newton_kernel"


def read(run):
    work = run.work("newton")
    if run.trace is None or work is None:
        return None
    us = run.trace.union_us(KERNEL)
    if us <= 0:
        return None
    least, _ = least_seconds(*work)
    return 100.0 * least * run.trace.calls / (us * 1e-6)
