"""The readers of the program's spans on hand-built traces: the idle
gaps and host time inside the program's ``dsp.*`` ranges, and the
stages' device time a call from the program's in-process records."""

import sys
import types

import pytest

from harness import manifest, runner
from harness.trace import Trace

PROFILING = "diffsptk_tpu_torch.utils.profiling"


def metric(name):
    return manifest.module("metrics", name)


def run_of(*traces, **kwargs):
    """A run whose rank 0 traced ``traces[0]`` (and the other ranks the
    rest)."""
    cell = types.SimpleNamespace(bench=manifest.BENCH)
    run = runner.Run(cell=cell, setup_s=0.0, samples_per_call=1,
                     trace=traces[0], **kwargs)
    if len(traces) > 1:
        run.traces = list(traces)
    return run


@pytest.fixture
def program(monkeypatch):
    """The program's profiling module as the readers find it in the
    process, with the stage records that ``records`` holds."""
    records = {}
    fake = types.SimpleNamespace(stage_ms=lambda: dict(records))
    monkeypatch.setitem(sys.modules, PROFILING, fake)
    return records


def test_idle_counts_gaps_under_the_program_and_not_under_the_loop():
    device = [("k1", 0.0, 10.0), ("k2", 14.0, 20.0), ("k3", 30.0, 40.0)]
    host = [("bench.call", 0.0, 45.0), ("dsp.analysis", 0.0, 18.0),
            ("dsp.Frame", 11.0, 13.0)]
    # gap 10-14 (middle 12, under dsp.Frame in dsp.analysis) counts;
    # gap 20-30 (middle 25, under bench.call alone) does not
    t = Trace(calls=2, window_s=1.0, device=device, host=host)
    assert metric("idle_ms.program").read(run_of(t)) == pytest.approx(
        4.0 / 1e3 / 2)


def test_idle_takes_the_rank_with_the_most_and_needs_a_span():
    quiet = Trace(calls=1, window_s=1.0,
                  device=[("k", 0.0, 1.0), ("k", 3.0, 4.0)],
                  host=[("dsp.x", 0.0, 4.0)])
    busy = Trace(calls=1, window_s=1.0,
                 device=[("k", 0.0, 1.0), ("k", 9.0, 10.0)],
                 host=[("dsp.x", 0.0, 10.0)])
    assert metric("idle_ms.program").read(run_of(quiet, busy)) == \
        pytest.approx(8.0 / 1e3)
    bare = Trace(calls=1, window_s=1.0, device=quiet.device,
                 host=[("bench.call", 0.0, 4.0)])
    assert metric("idle_ms.program").read(run_of(bare)) is None


def test_host_sums_only_the_outermost_program_spans():
    host = [("bench.call", 0.0, 100.0),
            ("dsp.analysis_synthesis", 10.0, 40.0),
            ("dsp.analysis", 10.0, 25.0), ("dsp.Frame", 12.0, 14.0),
            ("dsp.synthesis", 26.0, 40.0),
            ("dsp.ShardedPQMF", 50.0, 60.0), ("aten::mm", 70.0, 80.0)]
    t = Trace(calls=2, window_s=1.0, device=[], host=host)
    host_ms = metric("host_ms.program")
    assert host_ms.outermost(host) == [(10.0, 40.0), (50.0, 60.0)]
    assert host_ms.read(run_of(t)) == pytest.approx(40.0 / 1e3 / 2)
    other = Trace(calls=1, window_s=1.0, device=[],
                  host=[("dsp.x", 0.0, 100.0)])
    assert host_ms.read(run_of(t, other)) == pytest.approx(0.1)
    none = Trace(calls=1, window_s=1.0, host=[("bench.call", 0.0, 9.0)])
    assert host_ms.read(run_of(none)) is None


@pytest.mark.parametrize("name,stages", [
    ("span_ms.analysis", {"analysis": [4.0, 5.0]}),
    ("span_ms.synthesis", {"synthesis": [6.0, 3.0]}),
    ("span_ms.cqt_icqt", {"ShardedCQT": [2.0], "ShardedICQT": [7.0]}),
    ("span_ms.halo", {"halo": [1.5, 7.5]}),
])
def test_stage_readers_divide_by_every_attempts_calls(program, name,
                                                      stages):
    program.update(stages, unrelated=[100.0])
    # rank 0's window, traced twice (3 calls each); the records are its
    # process's own, whatever the other rank traced
    rank0 = Trace(calls=3, window_s=1.0, attempts=2)
    rank1 = Trace(calls=5, window_s=1.0)
    assert metric(name).read(run_of(rank0, rank1)) == pytest.approx(
        9.0 / 6)


@pytest.mark.parametrize("name", ["span_ms.analysis", "span_ms.synthesis",
                                  "span_ms.cqt_icqt", "span_ms.halo"])
def test_stage_readers_find_nothing_without_records(program, monkeypatch,
                                                    name):
    t = Trace(calls=3, window_s=1.0)
    program.update(unrelated=[1.0])
    assert metric(name).read(run_of(t)) is None
    # a program that records no stages at all, and an untraced run
    monkeypatch.setitem(sys.modules, PROFILING, types.SimpleNamespace())
    assert metric(name).read(run_of(t)) is None
    monkeypatch.delitem(sys.modules, PROFILING)
    assert metric(name).read(run_of(t)) is None
    assert metric(name).read(run_of(None)) is None
