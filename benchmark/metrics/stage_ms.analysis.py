"""Median CUDA-event ms of the entry's ``analysis`` span on the cell's
batch (the front end and mel-cepstral analysis), timed by the benchmark
around the program's public call."""

import statistics


def read(run):
    ms = run.spans_ms.get("analysis")
    return statistics.median(ms) if ms else None
