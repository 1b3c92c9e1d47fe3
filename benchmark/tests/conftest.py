"""Shared pieces of the benchmark's tests.

``checkout`` copies ``BENCHMARK.json`` and ``benchmark/`` into a
temporary directory, links the program beside them, and adds, as new
files and entries only, one small cell per request that the CPU runs in
seconds: ``small.resynth16``, ``small.extract16`` and ``small.resynth48``.
Their limits are the real cells' (``cells/mcep16k.resynth.json`` and
so on), so the tests hold the small cells to what the card is held to.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

SMALL = {
    # name: (the real cell it shrinks, batch, samples)
    "small.resynth16": ("mcep16k.resynth", 2, 8000),
    "small.extract16": ("mcep16k.extract", 2, 8000),
    "small.resynth48": ("mcep48k.resynth", 4, 48000),
}


def copy_checkout(dst: str) -> dict:
    """The benchmark and its manifest under ``dst``, with the small
    cells added; returns the manifest."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(ROOT, "diffsptk_tpu_torch"),
               os.path.join(dst, "diffsptk_tpu_torch"))
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    for name, (real, batch, samples) in SMALL.items():
        w = dict(cells[real], name=name, traffic=name,
                 why="a small copy for the CPU tests")
        add_traffic(dst, w["traffic"], cells[real]["traffic"], batch=batch,
                    samples=samples, pool=2, compare_calls=2,
                    compare_within=2)
        with open(os.path.join(dst, "benchmark", "cells",
                               f"{real}.json")) as f:
            spec = json.load(f)
        spec.update(trace_calls=3, span_reps=2)
        write_json(os.path.join(dst, "benchmark", "cells", f"{name}.json"),
                   spec)
        manifest["workloads"].append(w)
        for group in ("end_to_end", "per_layer"):
            for m in manifest[group]:
                if real in m.get("workloads", ()):
                    m["workloads"].append(name)
    write_json(path, manifest)
    return manifest


def add_traffic(dst: str, name: str, like: str, **changes) -> None:
    with open(os.path.join(dst, "benchmark", "traffic",
                           f"{like}.json")) as f:
        traffic = json.load(f)
    traffic.update(changes)
    write_json(os.path.join(dst, "benchmark", "traffic", f"{name}.json"),
               traffic)


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture
def checkout(tmp_path):
    copy_checkout(str(tmp_path))
    return str(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
