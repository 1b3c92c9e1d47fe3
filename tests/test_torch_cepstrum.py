"""The port's cepstrum conversions (ops/cep.py) and mel-cepstrum power
utilities (ops/mcpf.py) against the JAX package on the CPU, on numpy
inputs from a seed: fftcep with and without its aliasing correction,
c2acr, c2mpir / mpir2c, c2ndps / ndps2c, the cepstral distance in every
reduction, pnorm / ipnorm, the postfilter (its weights carried by
``load_jax_params``) and the MLSA stability check in its three modes.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py)."""

from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
RNG = np.random.default_rng(31)
# cepstra that decay like a speech envelope's, 2 x 3 frames of order 15
C = RNG.standard_normal((2, 3, 16)) * 0.6 ** np.arange(16)
SP = np.abs(np.fft.rfft(RNG.standard_normal((2, 3, 64)))) ** 2 + 1e-2


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _pair(name, args, kw, x, dtype):
    """The JAX op and the port's on the same input at ``dtype``."""
    jdt = J_DTYPE[dtype]
    cls = getattr(dsp, name)
    if "dtype" in inspect.signature(cls).parameters:
        kw = dict(kw, dtype=jdt)
    j = cls(*args, **kw)
    kw.pop("dtype", None)
    t = getattr(pt, name)(*args, **kw, device="cpu", dtype=dtype)
    return (t(torch.as_tensor(x, dtype=dtype)),
            j(jnp.asarray(x, jdt)))


CASES = [
    ("CepstralAnalysis", (64, 10), {}, SP),
    ("CepstralAnalysis", (64, 10), dict(n_iter=3, accel=0.1), SP),
    ("CepstralAnalysis", (64, 32), dict(n_iter=2), SP),
    ("CepstrumToAutocorrelation", (15, 8), dict(n_fft=64), C),
    ("CepstrumToMinimumPhaseImpulseResponse", (15, 40), dict(n_fft=64), C),
    ("CepstrumToNegativeDerivativeOfPhaseSpectrum", (15, 64), {}, C),
    ("CepstrumToNegativeDerivativeOfPhaseSpectrum", (15, 30), {}, C),
    ("MelCepstrumPowerNormalization", (15,), dict(alpha=0.42,
                                                   ir_length=64), C),
    ("MelCepstrumInversePowerNormalization", (14,), {}, C),
    ("MelCepstrumPostfiltering", (15,), dict(alpha=0.42, beta=0.2), C),
    ("MLSADigitalFilterStabilityCheck", (15,), dict(alpha=0.42), C * 4),
    ("MLSADigitalFilterStabilityCheck", (15,),
     dict(alpha=0.42, fast=False, n_fft=64), C * 4),
    ("MLSADigitalFilterStabilityCheck", (15,),
     dict(alpha=0.42, fast=False, n_fft=64, mod_type="clip",
          pade_order=5, strict=False), C * 4),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_matches_jax(case, dtype):
    name, args, kw, x = CASES[case]
    got, want = _pair(name, args, kw, x, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_inverse_conversions_match_jax(dtype):
    """mpir2c and ndps2c on the forward conversions' outputs."""
    jdt = J_DTYPE[dtype]
    kw = dict(device="cpu", dtype=dtype)
    h = np.asarray(dsp.CepstrumToMinimumPhaseImpulseResponse(
        15, 64, n_fft=64)(jnp.asarray(C)))
    _close(pt.MinimumPhaseImpulseResponseToCepstrum(64, 15, n_fft=64, **kw)(
        torch.as_tensor(h, dtype=dtype)),
        dsp.MinimumPhaseImpulseResponseToCepstrum(64, 15, n_fft=64)(
            jnp.asarray(h, jdt)), dtype)
    n = np.asarray(dsp.CepstrumToNegativeDerivativeOfPhaseSpectrum(15, 64)(
        jnp.asarray(C)))
    for order in (15, 32):
        _close(pt.NegativeDerivativeOfPhaseSpectrumToCepstrum(
            64, order, **kw)(torch.as_tensor(n, dtype=dtype)),
            dsp.NegativeDerivativeOfPhaseSpectrumToCepstrum(64, order)(
                jnp.asarray(n, jdt)), dtype)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("reduction", ["none", "sum", "mean", "batchmean"])
def test_cepstral_distance_matches_jax(reduction, full):
    c2 = C + 0.05 * RNG.standard_normal(C.shape)
    got = pt.CepstralDistance(full=full, reduction=reduction, device="cpu",
                              dtype=torch.float64)(torch.as_tensor(C),
                                                   torch.as_tensor(c2))
    want = dsp.CepstralDistance(full=full, reduction=reduction)(
        jnp.asarray(C), jnp.asarray(c2))
    _close(got, want)


def test_power_normalization_round_trip():
    kw = dict(device="cpu", dtype=torch.float64)
    c = torch.as_tensor(C)
    y = pt.MelCepstrumPowerNormalization(15, alpha=0.42, **kw)(c)
    torch.testing.assert_close(
        pt.MelCepstrumInversePowerNormalization(15, **kw)(y), c)


def test_postfilter_carries_jax_weights():
    """The postfilter's weights and warp matrices load by the JAX
    object's attribute paths."""
    j = dsp.MelCepstrumPostfiltering(15, alpha=0.42, beta=0.2)
    w = np.asarray(j.params["weight"]) * np.linspace(0.9, 1.1, 16)
    A = np.asarray(j.freqt.params["A"]) * 1.01
    want = j.apply({"weight": jnp.asarray(w)}, jnp.asarray(C))
    t = pt.MelCepstrumPostfiltering(15, alpha=0.42, beta=0.2, device="cpu",
                                    dtype=torch.float64)
    pt.load_jax_params(t, {"weight": w})
    _close(t(torch.as_tensor(C)), want)
    pt.load_jax_params(t, {"freqt.A": A})
    j.freqt.params["A"] = jnp.asarray(A)
    _close(t(torch.as_tensor(C)),
           j.apply({"weight": jnp.asarray(w)}, jnp.asarray(C)))
