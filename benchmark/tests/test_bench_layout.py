"""The harness finds a configuration, a cell and a per-layer metric that
are added as new files and entries, and edits no file that is there."""

import hashlib
import json
import os
import time

import torch

from conftest import write_json
from harness import manifest, runner


def digests(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha1(
                    f.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_are_found_as_new_files(checkout):
    bench = os.path.join(checkout, "benchmark")
    before = digests(checkout)
    with open(os.path.join(bench, "configs", "mcep16k.json")) as f:
        config = json.load(f)
    config.update(name="mcep16k_a031")
    config["program"]["alpha"] = 0.31
    write_json(os.path.join(bench, "configs", "mcep16k_a031.json"), config)
    with open(os.path.join(bench, "metrics", "calls_traced.py"), "w") as f:
        f.write('"""Calls in the traced window."""\n\n\n'
                "def read(run):\n"
                "    return None if run.trace is None else run.trace.calls\n")
    write_json(os.path.join(bench, "cells", "mcep16k_a031.small.json"),
               {"limits": {"mc_gap": 1e-3}, "trace_calls": 2,
                "span_reps": 1})
    path = os.path.join(checkout, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "mcep16k_a031", "source": "a test",
                         "file": "benchmark/configs/mcep16k_a031.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "mcep16k_a031.small",
                           "config": "mcep16k_a031",
                           "traffic": "small.extract16", "chips": 1,
                           "why": "a test"})
    m["per_layer"].append({"name": "calls_traced", "unit": "count",
                           "better": "higher", "source": "device_trace",
                           "layer": "host", "moves": "samples_per_s",
                           "workloads": ["mcep16k_a031.small"]})
    write_json(path, m)

    out = runner.run(checkout, "mcep16k_a031.small", 7, 0.1, True,
                     torch.device("cpu"), time.perf_counter(), bench=bench)
    assert out["metrics"]["calls_traced"] == {"value": 2.0,
                                              "unit": "count"}
    assert out["correct"] and out["checks"]["mc_gap"]["value"] < 1e-3
    cell = manifest.find(checkout, "mcep16k_a031.small", bench)
    assert cell.config["program"]["alpha"] == 0.31
    after = digests(checkout)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_named_part_exists():
    root = os.path.dirname(manifest.BENCH)
    m = manifest.load_json(os.path.join(root, "BENCHMARK.json"))
    for w in m["workloads"]:
        cell = manifest.find(root, w["name"])
        manifest.module("entries", cell.traffic["request"])
        manifest.module("signals", cell.traffic["signal"])
        manifest.module("reference", cell.config["reference"])
        entry = manifest.module("entries", cell.traffic["request"])
        assert set(cell.spec["limits"]) == set(entry.CHECKS)
    for group in ("end_to_end", "per_layer"):
        for metric in m[group]:
            assert callable(manifest.module("metrics", metric["name"]).read)
