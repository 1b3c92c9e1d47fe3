"""The port's excitation generation and m-sequence against the JAX package
on the CPU at float64, unpatched: both sides draw JAX's threefry stream
under ``PRNGKey(seed)`` (the port from utils/prng.py), so the Gaussian
and uniform unvoiced noise and a random initial phase are the same
numbers.  The pitch track (in samples) has a falling voiced run, an
unvoiced stretch and a rising run; row 1 has a short unvoiced gap.

Tolerance: rtol 1e-5 / atol 1e-8 (tests/utils.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
P = 80
VOICED = ("pulse", "harmonic-pulse", "sinusoidal", "sawtooth",
          "inverted-sawtooth", "triangle", "square")
UNVOICED = ("zeros", "gauss", "m-sequence", "uniform")


def _pitch() -> np.ndarray:
    p = np.concatenate([np.linspace(100.0, 60.0, 30), np.zeros(10),
                        np.linspace(80.0, 120.0, 20)])
    p = np.stack([p, p[::-1]])
    p[1, 5:9] = 0.0
    return p


def _check(**kw):
    want = np.asarray(dsp.ExcitationGeneration(P, **kw)(jnp.asarray(
        _pitch())))
    got = pt.ExcitationGeneration(P, **kw, **F64)(torch.as_tensor(_pitch()))
    assert got.shape == want.shape == (2, 60 * P)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    return want


@pytest.mark.parametrize("init_phase", ["zeros", 0.7, "random"])
@pytest.mark.parametrize("unvoiced", UNVOICED)
@pytest.mark.parametrize("voiced", VOICED)
def test_excitation_matches_jax(voiced, unvoiced, init_phase):
    want = _check(voiced_region=voiced, unvoiced_region=unvoiced,
                  init_phase=init_phase)
    if unvoiced != "zeros":
        assert np.abs(want[0, 31 * P:39 * P]).min() > 0   # noise drawn


@pytest.mark.parametrize("polarity", ["unipolar", "bipolar"])
@pytest.mark.parametrize("voiced", ["pulse", "harmonic-pulse", "triangle",
                                    "square"])
def test_excitation_polarity_matches_jax(voiced, polarity):
    _check(voiced_region=voiced, unvoiced_region="gauss", polarity=polarity,
           seed=3)


def test_excitation_rejects_bad_options():
    x = torch.as_tensor(_pitch())
    for kw in (dict(voiced_region="noise"), dict(unvoiced_region="pink"),
               dict(polarity="tripolar"), dict(init_phase="ones")):
        with pytest.raises(ValueError):
            pt.ExcitationGeneration(P, **kw, **F64)(x)
    with pytest.raises(ValueError):
        pt.ExcitationGeneration(0, **F64)


@pytest.mark.parametrize("shape", [(7,), (3, 50), (2, 2, 9)])
def test_mseq_matches_jax(shape):
    want = np.asarray(dsp.mseq(*shape))
    got = pt.mseq(*shape, device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(got.numpy(), want)
    like = pt.mseq_like(torch.zeros(4, 10, dtype=torch.float32))
    np.testing.assert_array_equal(like.numpy(), np.asarray(
        dsp.mseq(4, 9), np.float32))
