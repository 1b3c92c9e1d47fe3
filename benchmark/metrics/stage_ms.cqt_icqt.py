"""Median CUDA-event ms on rank 0 of the entry's ``cqt_icqt`` span: the
sharded CQT then ICQT of the rank's block, ended when every rank's is."""

import statistics


def read(run):
    ms = run.spans_ms.get("cqt_icqt")
    return statistics.median(ms) if ms else None
