"""Device idle ms a traced call inside the program: the gaps between
device functions (as ``Trace.idle_gaps`` finds them) whose middle lies
within one of the program's ``dsp.*`` host ranges, from the profiler's
trace, host and device on one clock.  That is the device waiting on the
program's own host code, not on the benchmark's loop and synchronise;
on several cards the rank where it is largest.  None where the trace
holds no such span (a program without them)."""

import bisect

from harness.manifest import module


def idle_us(device, spans) -> float:
    """Microseconds of the gaps between ``device``'s (name, start_us,
    end_us) functions whose middle lies within one of ``spans``, sorted
    (start_us, end_us) ranges that do not overlap."""
    starts = [s for s, _ in spans]
    total, end = 0.0, None
    for s, e in sorted((s, e) for _, s, e in device):
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                total += s - end
        end = e if end is None else max(end, e)
    return total


def read(run):
    host = module("metrics", "host_ms.program", run.cell.bench)
    found = []
    for t in run.all_traces():
        spans = host.outermost(t.host)
        if spans and t.device:
            found.append(idle_us(t.device, spans) / 1e3 / t.calls)
    return max(found) if found else None
