"""run.py measures on the card only: without one it exits non-zero and
prints no result, and never falls back to the CPU.  With a card it runs
a cell (``gpu``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import manifest

ROOT = os.path.dirname(manifest.BENCH)


def run(cwd: str, *extra: str, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"),
         "--workload", "mcep16k.extract", "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_no_card_exits_nonzero_without_a_result():
    done = run(ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "no CUDA device" in done.stderr


def test_a_directory_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copytree(manifest.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    done = run(str(tmp_path), env=env)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(cuda):
    done = run(ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"samples_per_s", "call_ms_p95",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
