"""STRAIGHT's spectral envelope in the port against the JAX package on the
CPU at float64: ``PitchAdaptiveSpectralAnalysis(algorithm="straight")`` on
synthetic speech with a gliding f0 and an unvoiced stretch, and the
over-smoothing compensation coefficients.  The JAX reference is computed
once (jitted).

Tolerance: rtol 1e-5 / atol 1e-8 (tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu.ops import straight as jst
from diffsptk_tpu_torch.ops import straight as tst

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
SR, FP, FFT, T = 16000, 80, 2048, 4000
N = T // FP + 1
FORMATS = ("db", "log-magnitude", "magnitude", "power")


def _inputs():
    x = synth_speech(2, T).astype(np.float64)
    x[1] *= 1e-3                              # a quiet row
    f0 = np.stack([np.linspace(110.0, 180.0, N),
                   np.linspace(220.0, 150.0, N)])
    f0[:, 10:16] = 0.0
    return x, f0


@pytest.fixture(scope="module")
def ref():
    x, f0 = (jnp.asarray(a) for a in _inputs())
    ops = [dsp.PitchAdaptiveSpectralAnalysis(FP, SR, FFT,
                                             algorithm="straight",
                                             out_format=f) for f in FORMATS]
    out = jax.jit(lambda x, f0: [op(x, f0) for op in ops])(x, f0)
    return dict(zip(FORMATS, (np.asarray(o) for o in out)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_straight_matches_jax(ref, fmt):
    x, f0 = (torch.as_tensor(a) for a in _inputs())
    got = pt.PitchAdaptiveSpectralAnalysis(FP, SR, FFT, algorithm="straight",
                                           out_format=fmt, **F64)(x, f0)
    assert got.shape == ref[fmt].shape == (2, N, FFT // 2 + 1)
    np.testing.assert_allclose(got.numpy(), ref[fmt], rtol=RTOL, atol=ATOL)


def test_optimum_smoothing_matches_jax():
    assert tst.optimum_smoothing() == jst.optimum_smoothing()
    assert tst.optimum_smoothing(1.2, 0.5) == jst.optimum_smoothing(1.2, 0.5)
    for got, want in zip(tst.optimum_smoothing_system(),
                         jst.optimum_smoothing_system()):
        np.testing.assert_array_equal(got, want)


def test_straight_rejects_a_short_fft():
    with pytest.raises(ValueError, match="at least 1280"):
        pt.PitchAdaptiveSpectralAnalysis(FP, SR, 1024, algorithm="straight",
                                         **F64)
