"""The MLSA cascades' least time at the cell's shapes
(``work/mlsa_cascade.py`` against ``harness/peaks.py``) over the
device time of the fp32 cascade kernel's functions in the traced window
(the union of their intervals), in %, where the cell's cascades take the
tap-chunked geometry (taps past one frame period)."""

from harness.manifest import module
from harness.peaks import least_seconds

KERNEL = "stage_kernel"


def read(run):
    sizes = run.sizes("mlsa_cascade")
    chunked = module("work", "mlsa_cascade", run.cell.bench).chunked
    if run.trace is None or not sizes or not all(
            chunked(s["P"], s["M"]) for s in sizes):
        return None
    us = run.trace.union_us(KERNEL)
    if us <= 0:
        return None
    least, _ = least_seconds(*run.work("mlsa_cascade"))
    return 100.0 * least * run.trace.calls / (us * 1e-6)
