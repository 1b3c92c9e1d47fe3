"""A cell of several cards, on two gloo ranks of the CPU at a size it
holds, with four channels: the harness runs the sharded battery, its
windows' reference is exact where the program computes in float64 (the
margins cover every stage's reach), the program in float32 passes the
cell's limits and the control and each fault of ``compare.faults`` fail
them, and a run whose timed path is broken underneath comes out not
correct: each of those faults planted on the program's outputs (one
answer altered: the first step of each rank's block, which the
boundaries' windows hold), and the exchange between ranks left out."""

import json
import os
import time

import pytest

import calibrate
from conftest import add_traffic, write_json
from harness import manifest, ranks

SMALL = "small.battery2"
FAULTY = '''"""The battery with a fault planted under the timed call:
{fault}."""
import os

import torch.nn.functional as F

from harness.compare import faults
from harness.manifest import module

_real = module("entries", "battery_sharded", os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
CHECKS, AXES, spans = _real.CHECKS, _real.AXES, _real.spans
operations, reference = _real.operations, _real.reference


def _no_exchange(x, left, right, axis_obj, pad_mode=None, axis=-1):
    pad = [0, 0] * (x.ndim - (axis % x.ndim) - 1) + [left, right]
    return F.pad(x, pad)


def build(config, device, world):
    if "{fault}" == "exchange_left_out":
        import diffsptk_tpu_torch.parallel.filterbanks as fb
        fb.exchange_halo = _no_exchange
    return _real.build(config, device, world)


def call(state, x):
    out = _real.call(state, x)
    if "{fault}" == "exchange_left_out":
        return out
    return faults(out, x)["{fault}"]
'''


def small_cell(root: str, name: str, request: str = "battery_sharded",
               dtype: str = "float32") -> str:
    bench = os.path.join(root, "benchmark")
    m = manifest.load_json(os.path.join(root, "BENCHMARK.json"))
    real = next(w for w in m["workloads"] if w["name"] == "battery.sharded4")
    add_traffic(root, name, real["traffic"], request=request, batch=4,
                samples=360_448)
    spec = manifest.load_json(os.path.join(bench, "cells",
                                           "battery.sharded4.json"))
    write_json(os.path.join(bench, "cells", f"{name}.json"),
               dict(spec, trace_calls=1, span_reps=1))
    config = real["config"]
    if dtype != "float32":
        config = f"{real['config']}_{dtype}"
        c = manifest.load_json(os.path.join(bench, "configs",
                                            f"{real['config']}.json"))
        write_json(os.path.join(bench, "configs", f"{config}.json"),
                   dict(c, name=config, dtype=dtype))
        m["configs"].append(dict(m["configs"][0], name=config,
                                 file=f"benchmark/configs/{config}.json"))
    m["workloads"].append(dict(real, name=name, config=config,
                               traffic=name, chips=2))
    write_json(os.path.join(root, "BENCHMARK.json"), m)
    return bench


def run(root: str, name: str, bench: str, **kw) -> dict:
    return ranks.spawn(root, name, 2**31 + 41, 0.0, False, "cpu",
                       time.perf_counter(), bench=bench, **kw)


def test_float64_windows_equal_the_whole_signal(checkout):
    bench = small_cell(checkout, SMALL, dtype="float64")
    out = run(checkout, SMALL, bench)
    assert out["correct"]
    for name, c in out["checks"].items():
        assert c["value"] < 1e-11, name


def test_program_passes_and_control_fails(checkout):
    bench = small_cell(checkout, SMALL)
    out = run(checkout, SMALL, bench)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
    cell, _, windows = ranks.collect(checkout, SMALL, 2**31 + 41, 0.0,
                                     False, "cpu", time.perf_counter(),
                                     bench=bench)
    found = calibrate.window_readings(cell, windows, "cpu", control=True)
    assert found["program"] == {k: c["value"]
                                for k, c in out["checks"].items()}
    assert set(found) == {"program", "control", "half_batch", "one_value",
                          "synthesis_skipped"}
    for side, gaps in found.items():
        over = any(gaps[k] > c["limit"] for k, c in out["checks"].items())
        assert over == (side != "program"), (side, gaps)


@pytest.mark.parametrize("fault", ["half_batch", "one_value",
                                   "synthesis_skipped",
                                   "exchange_left_out"])
def test_a_broken_timed_path_is_not_correct(checkout, fault):
    request = f"faulty.battery.{fault}"
    with open(os.path.join(checkout, "benchmark", "entries",
                           f"{request}.py"), "w") as f:
        f.write(FAULTY.format(fault=fault))
    bench = small_cell(checkout, SMALL, request=request)
    out = run(checkout, SMALL, bench)
    assert out["correct"] is False and out["failed"] >= 1
    assert list(out)[-1] == "checks"
    json.dumps(out)
