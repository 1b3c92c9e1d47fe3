"""Median CUDA-event ms of the entry's ``synthesis`` span on the cell's
batch (the MLSA filter), timed by the benchmark around the program's
public call."""

import statistics


def read(run):
    ms = run.spans_ms.get("synthesis")
    return statistics.median(ms) if ms else None
