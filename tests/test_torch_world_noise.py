"""WORLD's random draws, unpatched: the port against the JAX package on the
CPU at float64, each side drawing its own noise.

D4C dithers every windowed waveform with standard normal noise of scale
1e-6, and the synthesis adds per-slot noise; the port draws both from its
copy of JAX's threefry stream (utils/prng.py), so it reproduces the JAX
package without patching.  The dither matters where the signal is quiet:
white noise of standard deviation 1e-3 and 1e-4, and speech with a quiet
lead-in.  Each JAX reference is computed once (jitted).

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
from diffsptk_tpu.models.world_vocoder import WorldVocoder as JWorldVocoder

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
SR, FP, FFT = 16000, 80, 1024
T = 3200
N = T // FP + 1


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _white(scale):
    return scale * np.random.default_rng(21).standard_normal((2, T))


def _f0():
    """A gliding f0 with an unvoiced stretch, as YIN would give."""
    f0 = np.stack([np.linspace(110.0, 180.0, N), np.linspace(220.0, 150.0,
                                                             N)])
    f0[:, 10:16] = 0.0
    return f0


def _lead_in_speech():
    """Synthetic speech whose first 1,000 samples are 1e-3 white noise."""
    x = synth_speech(2, T).astype(np.float64)
    x[:, :1000] = 1e-3 * np.random.default_rng(22).standard_normal((2, 1000))
    return x


@pytest.fixture(scope="module")
def ref():
    """The JAX package's D4C on white noise at both scales, and its
    WorldVocoder(ap_algorithm="d4c").analysis_synthesis on speech with a
    quiet lead-in."""
    d4c = jax.jit(dsp.Aperiodicity(FP, SR, FFT, algorithm="d4c"))
    f0 = jnp.asarray(_f0())
    out = {scale: np.asarray(d4c(jnp.asarray(_white(scale)), f0))
           for scale in (1e-3, 1e-4)}
    jv = JWorldVocoder(ap_algorithm="d4c")
    x = jnp.asarray(_lead_in_speech())
    out["analysis"] = [np.asarray(a) for a in jax.jit(jv.analyze)(x)]
    out["voc"] = np.asarray(jax.jit(jv.analysis_synthesis)(x))
    return out


@pytest.mark.parametrize("scale", [1e-3, 1e-4])
def test_d4c_on_quiet_white_noise(ref, scale):
    got = pt.Aperiodicity(FP, SR, FFT, algorithm="d4c", **F64)(
        torch.as_tensor(_white(scale)), torch.as_tensor(_f0()))
    assert got.shape == ref[scale].shape
    _close(got, ref[scale])


def test_world_vocoder_with_quiet_lead_in(ref):
    tv = pt.WorldVocoder(ap_algorithm="d4c", **F64)
    x = torch.as_tensor(_lead_in_speech())
    for got, want in zip(tv.analyze(x), ref["analysis"]):
        _close(got, want)
    y = tv.analysis_synthesis(x)
    assert y.shape == x.shape
    _close(y, ref["voc"])
