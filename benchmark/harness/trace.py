"""A traced window of calls, reduced from torch.profiler's events.

The profiler records the card's activity (kernels, copies, fills) and
the host's (the benchmark's ``bench.call`` spans, the library's
operators and the CUDA runtime calls).  From them: the device-busy time
(the union of the device functions' intervals, since kernels launched as
programmatic dependents overlap), each device function's time by name,
and the idle gaps between device functions, each named by what the host
was doing in its middle.  A window in which the profiler recorded no
device activity is traced once more, as chip_smoke.py's ``profile_chain``
(commit 2f79b3d) does: the profiler once dropped a short window's
records while the card ran.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    calls: int
    window_s: float
    device: list = field(default_factory=list)   # (name, start_us, end_us)
    host: list = field(default_factory=list)     # (name, start_us, end_us)
    attempts: int = 1

    def union_us(self, match=None) -> float:
        """Microseconds covered by device functions whose name holds
        ``match`` (all of them for None)."""
        spans = sorted((s, e) for n, s, e in self.device
                       if match is None or match in n)
        total, end = 0.0, float("-inf")
        for s, e in spans:
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def busy_s(self) -> float:
        return self.union_us() / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The device functions that took most time, summed by name."""
        by_name: dict = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n[:120], v] for n, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between device functions, summed by the
        innermost host event that held the gap's middle."""
        spans = sorted((s, e) for _, s, e in self.device)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_name: dict = {}
        end = None
        for s, e in spans:
            if end is not None and s > end:
                mid = 0.5 * (s + end)
                name = "no host event"
                i = bisect.bisect_right(starts, mid) - 1
                while i >= 0:
                    if host[i][2] >= mid:
                        name = host[i][0]
                        break
                    i -= 1
                by_name[name] = by_name.get(name, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        return sorted(([n[:120], v] for n, v in by_name.items()),
                      key=lambda kv: -kv[1])[:top]


def traced(call, calls: int, sync) -> Trace:
    """Run ``call(i)`` for i < ``calls``, each ended by ``sync()``, under
    the profiler; the window's host time is from the first call's start
    to the last one's end."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for attempt in range(2):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                with record_function("bench.call"):
                    call(i)
                    sync()
            window_s = time.perf_counter() - t0
        device, host = [], []
        for evt in prof.events():
            rec = (evt.name, evt.time_range.start, evt.time_range.end)
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                host.append(rec)
            elif not getattr(evt, "is_user_annotation", False):
                # a span's range on the device timeline is no device work
                device.append(rec)
        if device or attempt or len(activities) == 1:
            break
    return Trace(calls=calls, window_s=window_s, device=device, host=host,
                 attempts=attempt + 1)
