"""Profiling and throughput (counterpart of
``diffsptk_tpu/utils/profiling.py``).

* ``trace(dir)`` -- a context manager around ``torch.profiler`` that
  writes a chrome trace of host and device activity into ``dir``.
* ``span(name)`` -- a named range of the program, ``dsp.<name>``, on the
  profiler's clock beside the device functions; a context manager or a
  decorator.  It opens a profiler range (``record_function``'s fast
  form) only while a ``torch.profiler`` (or autograd profiler) records,
  and otherwise does nothing but test the profiler's flag.  Nested spans of one thread are
  nested ranges; the outermost one marks a call of the program.
* ``stage(name, device)`` -- a span of a layer whose device time is also
  recorded: on a CUDA ``device`` whose current stream is not capturing
  a graph, a pair of timing events on that stream, kept in a bounded
  list that ``stage_ms()`` reads once the work has run.
* ``Throughput`` -- a samples/s meter on the host clock that waits for
  the card (``torch.cuda.synchronize``) before it reads the clock.

The spans of the program:

* every operator call (``BaseOp.forward``, and the operators that
  override it) is ``dsp.<class name>``;
* ``MelCepstralVocoder.analysis_synthesis`` is ``dsp.analysis_synthesis``;
  ``analyze`` is the stage ``analysis``, and each filter of the round
  trip and ``synthesize`` the stage ``synthesis``;
* each hand-written kernel's CUDA entry is ``dsp.kernel.<kernel>``: its
  argument checks, copies, allocations and launch;
* the sharded filterbanks' calls are ``dsp.Sharded<name>``, the CQT's and
  ICQT's as stages; each halo exchange is the stage ``halo``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

STAGE_RECORDS = 65536
"""The most stage records kept; the oldest go first."""

_stages: collections.deque = collections.deque(maxlen=STAGE_RECORDS)
"""(name, outermost call index, start event, stop event) of each stage
recorded on the card while a profiler recorded."""

_calls = itertools.count()
"""Index of the next outermost span."""


class _Nesting(threading.local):
    depth = 0
    call = -1


_nesting = _Nesting()


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


class _Site:
    """A span while no profiler records: entering it does nothing.  As a
    decorator it wraps ``fn`` so that each call opens the span where a
    profiler then records."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)

        return spanned


class _Range(_Site):
    """A span while a profiler records: a profiler range, and for a stage
    on a CUDA device a pair of timing events.  The range is
    ``record_function``'s fast form, which costs the host a fraction of
    ``record_function``'s time and marks no device-side range."""

    __slots__ = ("device", "_range", "_start")

    def __init__(self, name: str, device: torch.device | None = None) -> None:
        super().__init__(name)
        self.device = device
        self._start = None

    def __enter__(self) -> None:
        nest = _nesting
        if nest.depth == 0:
            nest.call = next(_calls)
        nest.depth += 1
        self._range = torch._C._profiler._RecordFunctionFast(
            "dsp." + self.name)
        self._range.__enter__()
        d = self.device
        if (d is not None and d.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(d))
        return None

    def __exit__(self, *exc) -> bool:
        try:
            if self._start is not None:
                stop = torch.cuda.Event(enable_timing=True)
                stop.record(torch.cuda.current_stream(self.device))
                _stages.append((self.name, _nesting.call, self._start, stop))
        finally:
            self._range.__exit__(*exc)
            _nesting.depth -= 1
        return False


_sites: dict = {}


def span(name: str):
    """The span ``dsp.<name>``: ``with span(name):`` or ``@span(name)``."""
    if _profiler._is_profiler_enabled:
        return _Range(name)
    site = _sites.get(name)
    if site is None:
        site = _sites[name] = _Site(name)
    return site


def stage(name: str, device: torch.device):
    """``span(name)`` whose device time on ``device`` is recorded too,
    for ``stage_ms``: ``with stage(name, x.device):``."""
    if _profiler._is_profiler_enabled:
        return _Range(name, device)
    return span(name)


def stage_ms(clear: bool = False) -> dict[str, list[float]]:
    """Device milliseconds of each stage recorded so far, by name: one
    entry for each outermost call that held the stage (the sum of its
    ranges in that call), in call order.  Empty where none was recorded:
    off the card, or while no profiler recorded.  Waits for the recorded
    work; ``clear`` then forgets the records."""
    by_name: dict = {}
    for name, call, start, stop in list(_stages):
        stop.synchronize()
        calls = by_name.setdefault(name, {})
        calls[call] = calls.get(call, 0.0) + start.elapsed_time(stop)
    if clear:
        _stages.clear()
    return {name: list(calls.values()) for name, calls in by_name.items()}


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
