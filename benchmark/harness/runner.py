"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's pool of input batches on the device from the
seed, builds the program, and runs ``warm_calls`` calls on the pool's
shape, so that the window compiles and builds nothing.  The window is a
closed loop with one batch in flight: each call takes the pool's next
batch and ends in a synchronise, and the loop runs until ``seconds``
have passed (untraced), or for the cell's ``trace_calls`` calls under
the profiler (traced).  The outputs of a sample of the window's calls,
drawn from the seed, are kept; once the window has closed, its peak
memory has been read and the program is freed, the plain reference
computes each kept call's batch again and each number of the entry's
``CHECKS`` is held to the cell's limit.
"""

from __future__ import annotations

import gc
import random
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from . import compare, manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "diffsptk_tpu")
"""Top-level module names that may not be loaded in a run."""


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: manifest.Cell
    setup_s: float
    samples_per_call: int
    calls: int = 0
    window_s: float = 0.0
    call_s: list = field(default_factory=list)
    spans_ms: dict = field(default_factory=dict)
    trace: trace.Trace | None = None
    traces: list = field(default_factory=list)
    """Every rank's traced window where the cell has several; else
    empty."""
    operations: list = field(default_factory=list)
    window_peak_bytes: int = 0

    def all_traces(self) -> list:
        """The traced window of each rank (rank 0's alone on one card)."""
        return [t for t in (self.traces or [self.trace]) if t is not None]

    def sizes(self, op: str) -> list[dict]:
        """The sizes of each of one call's ``op`` operations."""
        return [sizes for name, sizes in self.operations if name == op]

    def work(self, op: str) -> tuple[float, float] | None:
        """(operations, bytes) of one call's ``op``, or None where the
        call runs no such operation."""
        found = self.sizes(op)
        if not found:
            return None
        mod = manifest.module("work", op, self.cell.bench)
        parts = [mod.work(**sizes) for sizes in found]
        return sum(f for f, _ in parts), sum(b for _, b in parts)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sample_calls(seed: int, compare_calls: int, within: int) -> set:
    """The window's calls whose outputs are compared, besides its last:
    ``compare_calls`` - 1 drawn from the seed among the first
    ``within``."""
    rng = random.Random(seed)
    return set(rng.sample(range(within), max(0, compare_calls - 1)))


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, log=sys.stderr,
        bench: str = manifest.BENCH) -> dict:
    cell = manifest.find(root, workload, bench)
    tr, cfg = cell.traffic, cell.config
    entry = manifest.module("entries", tr["request"], bench)
    signal = manifest.module("signals", tr["signal"], bench)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    phases = {"imports": time.perf_counter() - t_start}
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
    phases["device"] = time.perf_counter() - t_start
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pool = [signal.make(gen, tr["batch"], tr["samples"], cfg["sample_rate"],
                        device) for _ in range(tr["pool"])]
    sync()
    phases["inputs"] = time.perf_counter() - t_start
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    state = entry.build(cfg, device)
    phases["program"] = time.perf_counter() - t_start
    with torch.inference_mode():
        for i in range(tr.get("warm_calls", 2)):
            entry.call(state, pool[i % len(pool)])
            sync()
            phases[f"warm call {i + 1}"] = time.perf_counter() - t_start
        rec = Run(cell=cell, setup_s=time.perf_counter() - t_start,
                  samples_per_call=tr["batch"] * tr["samples"],
                  operations=entry.operations(cfg, tr))
        setup_peak = (torch.cuda.max_memory_allocated(device) if on_card
                      else 0)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)

        n_traced = cell.spec["trace_calls"] if traced else None
        keep_at = sample_calls(seed, tr["compare_calls"],
                               min(tr["compare_within"],
                                   n_traced or tr["compare_within"]))
        kept: dict = {}

        def one(i: int):
            out = entry.call(state, pool[i % len(pool)])
            if i in keep_at:
                kept[i] = entry.outputs(state, out)
            return out

        if traced:
            spans = entry.spans(state, pool[0])
            reps = cell.spec.get("span_reps", 10)
            for name, fn in spans.items():
                rec.spans_ms[name] = span_ms(fn, reps, on_card)
            del spans
            n = n_traced
            last = [None]

            def traced_call(i):
                last[0] = one(i)

            rec.trace = trace.traced(traced_call, n, sync)
            rec.calls, rec.window_s = n, rec.trace.window_s
            kept[n - 1] = entry.outputs(state, last[0])
        else:
            i, out = 0, None
            t_window = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                out = one(i)
                sync()
                t1 = time.perf_counter()
                rec.call_s.append(t1 - t0)
                i += 1
                if t1 - t_window >= seconds:
                    break
            rec.calls, rec.window_s = i, t1 - t_window
            kept[i - 1] = entry.outputs(state, out)
            del out
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec.window_peak_bytes = window_peak
    memory_peak = max(setup_peak, window_peak)
    found = forbidden_modules()

    # The program's state goes before the reference runs; the kept
    # outputs are the program's results, handed back to its caller.
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell.metrics(traced):
        value = manifest.module("metrics", m["name"], bench).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks, failed = judge(cell, entry, pool, kept, device)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": rec.calls, "failed": failed,
              "metrics": metrics,
              "device": device_line(device, cell.chips, memory_peak, rec)}
    if rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = checks
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        raise ForbiddenModules(found)
    print("set-up, seconds from the start at the end of each phase: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=log)
    if rec.trace is not None and rec.trace.attempts > 1:
        print("the profiler recorded no device activity in the first "
              "traced window; it was traced once more", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or of the JAX package were loaded "
                         "in the run: " + ", ".join(found))


def span_ms(fn, reps: int, on_card: bool) -> list:
    """CUDA-event milliseconds of each of ``reps`` calls of ``fn`` after
    one warm call (host milliseconds off the card)."""
    fn()
    out = []
    for _ in range(reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def judge(cell, entry, pool, kept: dict, device) -> tuple[dict, int]:
    """Each check's widest reading over the kept calls against its limit,
    and how many kept calls read over a limit."""
    ref = manifest.module("reference", cell.config["reference"], cell.bench)
    arith = compare.Arith("float64")
    limits = cell.spec["limits"]
    worst = {name: 0.0 for name in entry.CHECKS}
    failed = 0
    by_batch: dict = {}
    for i in sorted(kept):
        by_batch.setdefault(i % len(pool), []).append(i)
    with torch.inference_mode(), arith.scope():
        for b, calls in sorted(by_batch.items()):
            want = entry.reference(ref, cell.config, pool[b], arith)
            for i in calls:
                bad = False
                for name, key in entry.CHECKS.items():
                    gap = compare.widest_gap(kept[i][key], want[key])
                    worst[name] = max(worst[name], gap)
                    bad |= not gap <= limits[name]
                failed += bad
            del want
    return ({name: {"value": worst[name], "limit": limits[name]}
             for name in entry.CHECKS}, failed)


def device_line(device, chips: int, peak: int, rec: Run) -> dict:
    line = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if rec.trace is not None:
        line["busy_s"] = rec.trace.busy_s()
        line["window_s"] = rec.trace.window_s
    return line


def percentile(values: list, q: int) -> float:
    """The q-th percentile by Python's quantiles (exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[q - 1]
