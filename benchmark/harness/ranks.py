"""Cells of several cards: one process a card, one signal split in time.

``spawn`` starts a process a rank (``multiprocessing``'s spawn), joins
them in one process group (NCCL on the cards, gloo on the CPU for the
tests; a ``FileStore`` in a temporary directory, so nothing listens on a
port; NCCL's shared-memory transport off, so no rank writes to
``/dev/shm``).  Every rank makes its block of the signal on its card
from the seed and its rank, and runs the entry's call on it; a call ends
when every rank's work has ended (a one-value ``all_reduce`` after each
rank's synchronise, which also carries rank 0's decision to close the
window).  Rank 0 times the calls.

The check compares windows of every channel's outputs around each
boundary between ranks and at one place drawn from the seed: each rank
sends its part of the inputs and outputs of each window to rank 0, which
hands them to the parent process; once every rank has freed the program
and ended, the parent computes the plain reference on each window's
input segment with the reference's ``MARGIN`` on both sides, so the
window's outputs equal those of the whole signal.
"""

from __future__ import annotations

import datetime
import gc
import os
import queue
import random
import shutil
import sys
import tempfile
import time

import torch

from . import compare, manifest, runner, trace

DEADLINE = 330.0
"""Seconds the ranks may take together, and a collective may wait."""


def spawn(root: str, workload: str, seed: int, seconds: float,
          traced: bool, device_type: str, t_start: float,
          bench: str = manifest.BENCH, log=sys.stderr) -> dict:
    """The run's result line, checked in this process on its first card
    once every rank has ended."""
    cell, result, windows = collect(root, workload, seed, seconds, traced,
                                    device_type, t_start, bench, log)
    checks, failed = judge(cell, windows, torch.device(device_type, 0)
                           if device_type == "cuda" else torch.device("cpu"))
    line = {"correct": failed == 0 and all(c["value"] <= c["limit"]
                                           for c in checks.values()),
            "attempted": result.pop("attempted"), "failed": failed,
            **result, "checks": checks}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return line


def collect(root: str, workload: str, seed: int, seconds: float,
            traced: bool, device_type: str, t_start: float,
            bench: str = manifest.BENCH, log=sys.stderr):
    """Runs the ranks; returns the cell, rank 0's result line without
    its check, and the compared windows: (input segment, {output:
    window}) each, as numpy arrays of every channel."""
    import multiprocessing

    cell = manifest.find(root, workload, bench)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    os.environ["NCCL_SHM_DISABLE"] = "1"
    tmp = tempfile.mkdtemp(prefix="bench-ranks-")
    args = (cell.chips, os.path.join(tmp, "store"), out, root, workload,
            seed, seconds, traced, device_type, t_start, bench)
    procs = [ctx.Process(target=_rank, args=(r, *args))
             for r in range(cell.chips)]
    result, until = None, time.time() + DEADLINE
    try:
        for p in procs:
            p.start()
        while result is None and time.time() < until and not any(
                p.exitcode not in (None, 0) for p in procs):
            try:
                result = out.get(timeout=1.0)
            except queue.Empty:
                pass
    finally:
        for p in procs:
            p.join(timeout=60 if result is not None else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if result is None or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            "a rank failed or gave no result: exit codes "
            f"{[p.exitcode for p in procs]}")
    for line in result.pop("log"):
        print(line, file=log)
    if result.pop("forbidden"):
        raise runner.ForbiddenModules(result["forbidden_names"])
    return cell, result["result"], result["windows"]


def _rank(rank, world, store, out, root, workload, seed, seconds, traced,
          device_type, t_start, bench) -> None:
    import torch.distributed as dist

    on_card = device_type == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        result = run(rank, world, root, workload, seed, seconds, traced,
                     torch.device(device_type, rank) if on_card
                     else torch.device("cpu"), t_start, bench)
        if rank == 0:
            out.put(result)
    finally:
        dist.destroy_process_group()


def run(rank, world, root, workload, seed, seconds, traced, device,
        t_start, bench) -> dict | None:
    import torch.distributed as dist

    cell = manifest.find(root, workload, bench)
    tr, cfg = cell.traffic, cell.config
    entry = manifest.module("entries", tr["request"], bench)
    signal = manifest.module("signals", tr["signal"], bench)
    on_card = device.type == "cuda"
    flag = torch.zeros(1, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def all_done():
        """Every rank's call has ended; returns rank 0's stop flag."""
        sync()
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        sync()
        return bool(flag.item())

    phases = {"ranks up": time.perf_counter() - t_start}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 64 + rank)
    x = signal.make(gen, tr["batch"], tr["samples"], cfg["sample_rate"],
                    device)
    sync()
    phases["inputs"] = time.perf_counter() - t_start
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state = entry.build(cfg, device, world)
    with torch.inference_mode():
        for i in range(tr.get("warm_calls", 1)):
            entry.call(state, x)
            all_done()
            phases[f"warm call {i + 1}"] = time.perf_counter() - t_start
        rec = runner.Run(cell=cell, setup_s=time.perf_counter() - t_start,
                         samples_per_call=tr["batch"] * tr["samples"] * world,
                         operations=entry.operations(cfg, tr))
        setup_peak = torch.cuda.max_memory_allocated(device) if on_card \
            else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        out = None
        if traced:
            for name, fn in entry.spans(state, x).items():
                rec.spans_ms[name] = runner.span_ms(
                    lambda: (fn(), all_done()), cell.spec.get("span_reps", 3),
                    on_card)
            n = cell.spec["trace_calls"]
            last = [None]

            def call(i):
                last[0] = entry.call(state, x)

            rec.trace = trace.traced(call, n, all_done)
            rec.calls, rec.window_s, out = n, rec.trace.window_s, last[0]
        else:
            i = 0
            t_window = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                out = entry.call(state, x)
                sync()
                flag.fill_(float(rank == 0 and time.perf_counter()
                                 - t_window >= seconds))
                stop = all_done()
                t1 = time.perf_counter()
                rec.call_s.append(t1 - t0)
                i += 1
                if stop:
                    break
            rec.calls, rec.window_s = i, t1 - t_window
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    peaks = [None] * world
    dist.all_gather_object(peaks, (setup_peak, window_peak))
    rec.window_peak_bytes = max(w for _, w in peaks)
    memory_peak = max(max(p) for p in peaks)
    traces = [None] * world if rank == 0 else None
    dist.gather_object(rec.trace, traces, dst=0)
    rec.traces = traces or []

    # the windows compared, and each rank's part of their inputs and
    # outputs of every channel, on rank 0
    ref = manifest.module("reference", cfg["reference"], bench)
    rng = random.Random(seed)
    T_l, half = tr["samples"], tr["compare_half"]
    reach = half + ref.MARGIN
    centres = [r * T_l for r in range(1, world)]
    lo, hi = reach // ref.ALIGN + 1, (world * T_l - reach) // ref.ALIGN - 1
    if hi > lo:
        centres.append(rng.randint(lo, hi) * ref.ALIGN)
    centres = [c for c in centres if reach <= c <= world * T_l - reach]
    parts = []
    for c in centres:
        seg = (c - reach, c + reach)
        win = (c - half, c + half)
        parts.append((_cut(x, seg, rank, T_l, -1, 1),
                      {k: _cut(out[k], win, rank, T_l, axis, step)
                       for k, (axis, step) in entry.AXES.items()}))
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(parts, gathered, dst=0)
    found = runner.forbidden_modules()
    del state, out, x, parts
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()
    if rank != 0:
        return None

    metrics = {}
    for m in cell.metrics(traced):
        value = manifest.module("metrics", m["name"], bench).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"attempted": rec.calls, "metrics": metrics,
              "device": runner.device_line(device, world, memory_peak, rec)}
    if rec.trace is not None:
        each = rec.all_traces()
        result["device"]["busy_s"] = sum(t.busy_s() for t in each) / world
        result["device"]["window_s"] = sum(t.window_s for t in each) / world
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    windows = []
    for w in range(len(centres)):
        x_w = torch.cat([g[w][0] for g in gathered], dim=-1)
        outs = {k: torch.cat([g[w][1][k] for g in gathered], dim=axis)
                for k, (axis, _) in entry.AXES.items()}
        windows.append((x_w.numpy(), {k: v.numpy() for k, v in outs.items()}))
    log = ["set-up, seconds from the start at the end of each phase "
           "(rank 0): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    phases.items()),
           f"compared: windows of {2 * half} samples of all "
           f"{tr['batch']} channels at {centres}"]
    return {"result": result, "windows": windows, "log": log,
            "forbidden": bool(found), "forbidden_names": found}


def _cut(t: torch.Tensor, span, rank: int, T_l: int, axis: int,
         step: int) -> torch.Tensor:
    """This rank's part of the global sample range ``span`` of ``t``,
    whose ``axis`` holds one entry every ``step`` samples from the
    rank's first sample, as a CPU tensor (empty where it has none)."""
    a = min(max(span[0] - rank * T_l, 0), T_l)
    b = min(max(span[1] - rank * T_l, a), T_l)
    a, b = (min(-(-v // step), t.shape[axis]) for v in (a, b))
    return t.narrow(axis, a, b - a).cpu()


def compared(cell, windows, device, *ariths):
    """For each window: its input segment over the outputs' span, the
    program's outputs, and the plain reference's in each of ``ariths``
    cut to that span, all on ``device``."""
    entry = manifest.module("entries", cell.traffic["request"], cell.bench)
    ref = manifest.module("reference", cell.config["reference"], cell.bench)
    margin = ref.MARGIN
    with torch.inference_mode():
        for x, got in windows:
            x = torch.as_tensor(x).to(device)
            got = {k: torch.as_tensor(v).to(device) for k, v in got.items()}
            refs = []
            for arith in ariths:
                with arith.scope():
                    full = entry.reference(ref, cell.config, x, arith)
                refs.append({k: full[k].narrow(axis, margin // step,
                                               got[k].shape[axis])
                             for k, (axis, step) in entry.AXES.items()})
                del full
            yield (x.narrow(-1, margin, x.shape[-1] - 2 * margin), got,
                   *refs)


def judge(cell, windows, device) -> tuple[dict, int]:
    """Each check's widest gap over the windows against its limit: the
    largest |out - ref| in any window over the largest |ref| in all of
    them (a window can lie where an output is small: the CQT's bins end
    at 131 Hz, and a block's middle holds f0 above them); and how many
    windows read over a limit."""
    entry = manifest.module("entries", cell.traffic["request"], cell.bench)
    limits = cell.spec["limits"]
    parts = [{name: compare.gap_parts(got[key], want[key])
              for name, key in entry.CHECKS.items()}
             for _, got, want in compared(cell, windows, device,
                                          compare.Arith("float64"))]
    gaps = compare.pooled(parts)
    scale = {name: max(p[name][1] for p in parts) for name in gaps}
    failed = sum(any(p[name][0] / scale[name] > limits[name] for name in p)
                 for p in parts)
    return ({name: {"value": gaps[name], "limit": limits[name]}
             for name in entry.CHECKS}, failed)
