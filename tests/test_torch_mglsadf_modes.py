"""The rest of MLSA synthesis against the JAX package on the CPU: mc2b /
b2mc, mgc2sp in every output format, the all-zero filter's FFT path (M+1
= 41), and the four ``mglsadf`` modes in every phase each accepts
(``multi-stage`` with ``cascade="stages"``, ``single-stage``,
``freq-domain``, ``pade-approx`` with and without chunking), with and
without ``ignore_gain``; then ``MelCepstralVocoder(mode=...)`` end to end,
the Pade weights, its complex64 sections in a float32 module, and
``load_jax_params`` for Pade's ``a1`` and the stages cascade's ``a``.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py).  Each vocoder's JAX reference is jitted and computed once.
"""

from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu.models.mcep_vocoder import MelCepstralVocoder as JVocoder
from diffsptk_tpu.ops.mglsadf import _exp_pade_weights as j_pade_weights
from diffsptk_tpu_torch.kernels import recurrence
from diffsptk_tpu_torch.ops.mglsadf import _exp_pade_weights

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(61)
B, N, P = 2, 6, 16
X = RNG.standard_normal((B, N * P))
MODES = {
    "stages": dict(mode="multi-stage", cascade="stages", cep_order=39,
                   taylor_order=6),
    "single": dict(mode="single-stage", ir_length=64, n_fft=256),
    "freq": dict(mode="freq-domain", frame_length=64, fft_length=64,
                 n_fft=128),
    "pade": dict(mode="pade-approx", cep_order=39),
    "pade-chunked": dict(mode="pade-approx", cep_order=39, chunk_length=32,
                         warmup_length=16),
    "pade-order3": dict(mode="pade-approx", cep_order=39, pade_order=3),
}
PHASES = ("minimum", "maximum", "zero", "mixed")


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _mc(phase, order=4, seed=0):
    width = 2 * order + 1 if phase == "mixed" else order + 1
    return np.random.default_rng(seed).standard_normal((B, N, width)) * 0.1


@pytest.mark.parametrize("alpha", [0.0, 0.42, -0.3])
def test_mc2b_and_b2mc_match_jax(alpha):
    mc = RNG.standard_normal((2, 3, 7)) * 0.3
    b = pt.MelCepstrumToMLSADigitalFilterCoefficients(6, alpha, **F64)(
        torch.as_tensor(mc))
    _close(b, dsp.MelCepstrumToMLSADigitalFilterCoefficients(6, alpha)(
        jnp.asarray(mc)))
    back = pt.MLSADigitalFilterCoefficientsToMelCepstrum(6, alpha, **F64)(b)
    _close(back, dsp.MLSADigitalFilterCoefficientsToMelCepstrum(6, alpha)(
        jnp.asarray(b.numpy())))
    _close(back, mc)
    with pytest.raises(ValueError):
        pt.MelCepstrumToMLSADigitalFilterCoefficients(6, 1.0, device="cpu")
    with pytest.raises(ValueError):
        pt.MLSADigitalFilterCoefficientsToMelCepstrum(6, 0.1, **F64)(
            torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("out_format", [0, 1, 2, 3, 4, 5, 6, "db",
                                        "log-magnitude", "magnitude",
                                        "power", "cycle", "radian",
                                        "degree", "complex"])
def test_mgc2sp_matches_jax(out_format):
    mc = RNG.standard_normal((2, 3, 7)) * 0.3
    kw = dict(alpha=0.3, gamma=-0.5, out_format=out_format)
    got = pt.MelGeneralizedCepstrumToSpectrum(6, 32, **kw, **F64)(
        torch.as_tensor(mc))
    _close(got, dsp.MelGeneralizedCepstrumToSpectrum(6, 32, **kw)(
        jnp.asarray(mc)))


def test_mgc2sp_rejects_an_unknown_format():
    with pytest.raises(ValueError):
        pt.MelGeneralizedCepstrumToSpectrum(6, 32, out_format="x",
                                            device="cpu")


@pytest.mark.parametrize("ignore_gain,zeroth", [(False, 0), (False, 7),
                                                (True, 0)])
def test_zerodf_order_40_matches_jax(ignore_gain, zeroth):
    """M+1 = 41 > 32: the FFT path, and with ignore_gain the direct one."""
    x = RNG.standard_normal((2, 80))
    b = RNG.standard_normal((2, 10, 41))
    b[..., 0] += 2.0
    kw = dict(ignore_gain=ignore_gain, zeroth_index=zeroth)
    got = pt.AllZeroDigitalFilter(40, 8, **kw, **F64)(
        torch.as_tensor(x), torch.as_tensor(b))
    _close(got, dsp.AllZeroDigitalFilter(40, 8, **kw)(jnp.asarray(x),
                                                      jnp.asarray(b)))


def _mode_cases():
    for name, kw in MODES.items():
        phases = ("minimum",) if kw["mode"] == "pade-approx" else PHASES
        for phase in phases:
            for ignore_gain in (False, True):
                yield name, phase, ignore_gain


@pytest.mark.parametrize("name,phase,ignore_gain", list(_mode_cases()))
def test_mode_matches_jax(name, phase, ignore_gain):
    kw = dict(alpha=0.2, phase=phase, ignore_gain=ignore_gain, **MODES[name])
    mc = _mc(phase)
    want = dsp.MLSA(4, P, **kw)(jnp.asarray(X), jnp.asarray(mc))
    got = pt.MLSA(4, P, **kw, **F64)(torch.as_tensor(X), torch.as_tensor(mc))
    _close(got, want)


@pytest.mark.parametrize("name", list(MODES))
def test_mode_float32_matches_jax(name):
    kw = dict(alpha=0.2, **MODES[name])
    mc = _mc("minimum", seed=1)
    want = dsp.MLSA(4, P, **kw, dtype=jnp.float32)(
        jnp.asarray(X, jnp.float32), jnp.asarray(mc, jnp.float32))
    got = pt.MLSA(4, P, **kw, device="cpu", dtype=torch.float32)(
        torch.as_tensor(X, dtype=torch.float32),
        torch.as_tensor(mc, dtype=torch.float32))
    assert got.dtype == torch.float32
    _close(got, want, torch.float32)


def test_mode_arguments_are_checked():
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="pade-approx", phase="zero", device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="pade-approx", pade_order=2, device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="pade-approx", chunk_length=0, device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="freq-domain", frame_length=32, device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="single-stage", phase="linear", device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="multi-stage", cascade="direct", device="cpu")
    with pytest.raises(ValueError):
        pt.MLSA(4, P, mode="iir", device="cpu")


def test_pade_weights_are_exact():
    """The closed form (2L-k)! L! / ((2L)! k! (L-k)!) against exact
    rationals at every order, and against the JAX package's mpmath
    weights where those are accurate (their error grows past 1e-8 at
    order 12)."""
    f = math.factorial
    for order in range(3, 15):
        p = [Fraction(f(2 * order - k) * f(order),
                      f(2 * order) * f(k) * f(order - k))
             for k in range(order + 1)]
        exact = [1.0] + [float(p[k] / p[k - 1]) for k in range(1, order + 1)]
        np.testing.assert_allclose(_exp_pade_weights(order), exact,
                                   rtol=1e-15)
        if order <= 11:
            np.testing.assert_allclose(_exp_pade_weights(order),
                                       j_pade_weights(order), rtol=1e-6)


@pytest.mark.parametrize("order", [12, 13, 14])
def test_pade_high_orders_depart_from_jax_by_the_weights_alone(
        order, monkeypatch):
    """From order 12 the JAX package's mpmath weights drift from the exact
    ones, so the port's Pade filter departs from it there.  Given the JAX
    package's weights the port equals it at float64; with its own exact
    weights the output moves by less than a tenth of the weights' largest
    relative drift (measured on this case: 3.1e-7, 3.2e-6 and 2.1e-5 of
    max|y| at orders 12, 13 and 14, for drifts of 1.1e-5, 1.4e-4 and
    1.1e-3)."""
    from diffsptk_tpu_torch.ops import mglsadf

    kw = dict(alpha=0.2, mode="pade-approx", cep_order=39, pade_order=order)
    mc = _mc("minimum")
    want = np.asarray(dsp.MLSA(4, P, **kw)(jnp.asarray(X), jnp.asarray(mc)))
    exact = pt.MLSA(4, P, **kw, **F64)(torch.as_tensor(X),
                                        torch.as_tensor(mc)).numpy()
    monkeypatch.setattr(mglsadf, "_exp_pade_weights", j_pade_weights)
    _close(pt.MLSA(4, P, **kw, **F64)(torch.as_tensor(X),
                                      torch.as_tensor(mc)), want)
    drift = np.abs(_exp_pade_weights(order) / j_pade_weights(order) - 1).max()
    moved = np.abs(exact - want).max() / np.abs(want).max()
    assert 1e-6 < drift and moved < 0.1 * drift


def test_pade_sections_run_complex64_in_float32(monkeypatch):
    """A float32 Pade filter holds complex64 roots, so its five
    first-order sections reach the scan as complex64, the dtype the scan
    kernel takes on the card."""
    seen = []
    orig = recurrence.scan_diff

    def spy(p, x):
        seen.append(x.dtype)
        return orig(p, x)

    monkeypatch.setattr(recurrence, "scan_diff", spy)
    f = pt.MLSA(4, P, mode="pade-approx", cep_order=39, device="cpu",
                dtype=torch.float32)
    assert f.mglsadf.roots.dtype == torch.complex64
    y = f(torch.as_tensor(X, dtype=torch.float32),
          torch.as_tensor(_mc("minimum"), dtype=torch.float32))
    assert y.dtype == torch.float32
    assert seen == [torch.complex64] * 5


def test_load_jax_params_pade_a1():
    a1 = 1.0 + 0.1 * np.random.default_rng(62).standard_normal(6)
    mc = _mc("minimum", seed=2)
    jf = dsp.MLSA(4, P, mode="pade-approx", cep_order=39, learnable=True)
    jf.mglsadf.a1 = jnp.asarray(a1)
    want = jf(jnp.asarray(X), jnp.asarray(mc))
    tf = pt.MLSA(4, P, mode="pade-approx", cep_order=39, learnable=True,
                 **F64)
    assert [n for n, _ in tf.named_parameters()] == ["mglsadf.a1"]
    pt.load_jax_params(tf, {"mglsadf.a1": a1})
    got = tf(torch.as_tensor(X), torch.as_tensor(mc))
    _close(got, want)
    got.sum().backward()
    assert tf.mglsadf.a1.grad is not None


def test_load_jax_params_stages_a():
    a = 1.0 + 0.1 * np.random.default_rng(63).standard_normal(7)
    mc = _mc("minimum", seed=3)
    kw = dict(alpha=0.2, cascade="stages", cep_order=39, taylor_order=6,
              learnable=True)
    jf = dsp.MLSA(4, P, **kw)
    jf.mglsadf.a = jnp.asarray(a)
    want = jf(jnp.asarray(X), jnp.asarray(mc))
    tf = pt.MLSA(4, P, **kw, **F64)
    pt.load_jax_params(tf, {"mglsadf.a": a})
    _close(tf(torch.as_tensor(X), torch.as_tensor(mc)), want)


VOCODER = dict(frame_length=400, frame_period=80, fft_length=512,
               cep_order=24, alpha=0.42, n_iter=3, cep_order_mlsa=39,
               taylor_order=6)
VOCODER_MODES = {"multi-stage": dict(cascade="stages"), "single-stage": {},
                 "freq-domain": {}, "pade-approx": {}}
XV = np.random.default_rng(64).standard_normal((2, 1600))


@pytest.mark.parametrize("mode", list(VOCODER_MODES))
def test_vocoder_mode_matches_jax(mode):
    kw = dict(VOCODER, mode=mode, **VOCODER_MODES[mode])
    want = np.asarray(jax.jit(JVocoder(**kw).analysis_synthesis)(
        jnp.asarray(XV)))
    got = pt.MelCepstralVocoder(**kw, **F64).analysis_synthesis(
        torch.as_tensor(XV))
    _close(got, want)
