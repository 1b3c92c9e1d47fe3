"""The PyTorch port's examples (examples/torch_*.py) on the CPU: each runs
as its own process with ``--device cpu`` on a short synthetic signal
(the sharded ones on two gloo ranks), exits 0 and prints its result
line, and imports no JAX.

Bars, from the examples' CPU runs at these lengths: the mel-cepstral round
trip's SNR at least 20 dB (31.5 dB at 6,400 samples), CREPE-tiny within
50 cents of YIN and of the known f0 glide (medians 5.6 and 9.9 cents),
WORLD's spectrogram correlation at least 0.8 (0.933), the sharded vocoder
within 1e-2 of max|y| of the one-device vocoder (float32 round trips in
another order: 1.5e-3 to 2.0e-3), the sharded filterbanks equal to the
unsharded ones within 1e-5 and the MDCT round trip above 90 dB (128 dB).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_analysis_synthesis", "torch_neural_pitch",
            "torch_world_vocoder", "torch_sharded_vocoder",
            "torch_sharded_filterbanks")


def _run(name: str, *args: str) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
         "--device", "cpu", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _number(pattern: str, text: str) -> float:
    found = re.search(pattern, text)
    assert found, text
    return float(found.group(1))


@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH"])
def test_analysis_synthesis_example(precision):
    out = _run("torch_analysis_synthesis", "--length", "6400",
               "--precision", precision)
    assert _number(r"round-trip SNR: (-?[\d.]+) dB", out) >= 20.0


def test_neural_pitch_example():
    out = _run("torch_neural_pitch", "--length", "6400")
    assert _number(r"crepe-vs-yin median \|error\|: ([\d.]+) cents",
                   out) <= 50.0
    assert _number(r"crepe-vs-known-f0 median \|error\|: ([\d.]+) cents",
                   out) <= 50.0


def test_world_vocoder_example():
    out = _run("torch_world_vocoder", "--length", "6400")
    assert _number(r"correlation: ([\d.]+)", out) >= 0.8


def test_sharded_vocoder_example():
    out = _run("torch_sharded_vocoder", "--length", "6400", "--ranks", "2")
    assert "2 cpu ranks" in out
    assert _number(r"vocoder = ([\d.e+-]+)", out) <= 1e-2


def test_sharded_filterbanks_example():
    out = _run("torch_sharded_filterbanks", "--length", "6400", "--ranks",
               "2")
    assert _number(r"round-trip SNR ([\d.]+) dB", out) >= 90.0
    assert _number(r"MDCT leg ([\d.e+-]+)", out) <= 1e-5
    assert _number(r"PQMF leg ([\d.e+-]+)", out) <= 1e-5


def test_examples_import_no_jax():
    code = ("import importlib.util, os, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            f"for name in {EXAMPLES!r}:\n"
            "    path = os.path.join('examples', name + '.py')\n"
            "    spec = importlib.util.spec_from_file_location(name, path)\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    assert callable(mod.main)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
