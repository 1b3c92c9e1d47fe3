"""The comparison that decides ``correct``, at a size the CPU holds.

The control, the plain reference computed in float32 with TF32 products
in the program's place, reads over each cell's limits while the program
reads under them, and so does each fault of ``compare.faults``.  A run
whose timed path is broken underneath comes out not correct, for each
fault the cells can have, planted on the program's outputs as
``compare.faults`` plants it: half of the batch left out, one answer
altered where it is produced, and (where the call synthesises) the
synthesis skipped, the input handed back."""

import json
import os
import time

import pytest
import torch

from conftest import SMALL, add_traffic, write_json
from harness import compare, manifest, runner

FAULTY_ENTRY = '''"""{real} with a fault planted under the timed call:
{fault}."""
import os

from harness.compare import faults
from harness.manifest import module

_real = module("entries", "{real}", os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHECKS, build, spans = _real.CHECKS, _real.build, _real.spans
operations, reference = _real.operations, _real.reference


def call(state, x):
    state["x"] = x
    return _real.call(state, x)


def outputs(state, out):
    return faults(_real.outputs(state, out), state["x"])["{fault}"]
'''

FAULTS = {"small.resynth16": ("half_batch", "one_value",
                              "synthesis_skipped"),
          "small.extract16": ("half_batch", "one_value"),
          "small.resynth48": ("half_batch", "one_value",
                              "synthesis_skipped")}


@pytest.mark.parametrize("small", sorted(SMALL))
def test_program_passes_and_control_fails_the_limits(small):
    real, batch, samples = SMALL[small]
    cell = manifest.find(os.path.dirname(manifest.BENCH), real)
    cfg, limits = cell.config, cell.spec["limits"]
    entry = manifest.module("entries", cell.traffic["request"])
    ref = manifest.module("reference", cfg["reference"])
    gen = torch.Generator().manual_seed(2**31 + 99)
    x = manifest.module("signals", "speech").make(
        gen, batch, samples, cfg["sample_rate"], "cpu")
    f64, tf32 = compare.Arith("float64"), compare.Arith("tf32")
    with f64.scope():
        want = entry.reference(ref, cfg, x, f64)
    with tf32.scope():
        control = entry.reference(ref, cfg, x, tf32)
    state = entry.build(cfg, "cpu")
    with torch.inference_mode():
        got = entry.outputs(state, entry.call(state, x))
    found = compare.readings(entry.CHECKS, got, want, control, x)
    assert set(found) == {"program", "control", *FAULTS[small]}
    for side, parts in found.items():
        over = any(err / scale > limits[name]
                   for name, (err, scale) in parts.items())
        assert over == (side != "program"), (side, parts)


@pytest.mark.parametrize("small,fault", [(s, f) for s in sorted(FAULTS)
                                         for f in FAULTS[s]])
def test_a_broken_timed_path_is_not_correct(checkout, small, fault):
    bench = os.path.join(checkout, "benchmark")
    m = manifest.load_json(os.path.join(checkout, "BENCHMARK.json"))
    w = next(w for w in m["workloads"] if w["name"] == small)
    traffic = manifest.load_json(
        os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    entry = f"faulty.{traffic['request']}.{fault}"
    with open(os.path.join(bench, "entries", f"{entry}.py"), "w") as f:
        f.write(FAULTY_ENTRY.format(real=traffic["request"], fault=fault))
    name = f"{small}.{fault}"
    add_traffic(checkout, name, w["traffic"], request=entry)
    with open(os.path.join(bench, "cells", f"{small}.json")) as f:
        write_json(os.path.join(bench, "cells", f"{name}.json"),
                   json.load(f))
    m["workloads"].append(dict(w, name=name, traffic=name))
    write_json(os.path.join(checkout, "BENCHMARK.json"), m)

    out = runner.run(checkout, name, 2**31 + 17, 0.1, False,
                     torch.device("cpu"), time.perf_counter(), bench=bench)
    assert out["correct"] is False and out["failed"] >= 1
    assert list(out)[-1] == "checks"
