"""Profiling and throughput (counterpart of
``diffsptk_tpu/utils/profiling.py``).

* ``trace(dir)`` -- a context manager around ``torch.profiler`` that
  writes a chrome trace of host and device activity into ``dir``.
* ``Throughput`` -- a samples/s meter on the host clock that waits for
  the card (``torch.cuda.synchronize``) before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and the card where there is one) and
    write ``log_dir/trace.json``, a chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait until the device that holds ``out`` (a tensor, or a tuple or
    list holding tensors) has finished."""
    if isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


class Throughput:
    """Measure samples/s of a callable."""

    def __init__(self, fn, *, warmup: int = 3, iters: int = 10):
        self.fn = fn
        self.warmup = warmup
        self.iters = iters
        self.last_seconds_per_call: float | None = None

    def measure(self, *args, n_samples: int) -> float:
        for _ in range(self.warmup):
            _sync(self.fn(*args))
        t0 = time.perf_counter()
        out = None
        for _ in range(self.iters):
            out = self.fn(*args)
        _sync(out)
        dt = (time.perf_counter() - t0) / self.iters
        self.last_seconds_per_call = dt
        return n_samples / dt
