"""LPC analysis-synthesis ops of the port (acorr, levdur, rlevdur, lpc,
norm0, poledf) and the whole LPC chain at orders 24 and 1, against the
JAX package on the same numpy inputs, float64 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
L, P = 400, 80


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fmt", ["naive", "normalized", "biased",
                                 "unbiased", 3])
def test_acorr(fmt):
    x = _rng(0).standard_normal((2, 3, 30))
    want = dsp.Autocorrelation(30, 8, fmt)(jnp.asarray(x))
    _close(pt.Autocorrelation(30, 8, fmt, **F64)(torch.as_tensor(x)), want)


def test_acorr_checks():
    with pytest.raises(ValueError):
        pt.Autocorrelation(8, 8, device="cpu")
    with pytest.raises(ValueError):
        pt.Autocorrelation(8, 2, "bogus", device="cpu")
    with pytest.raises(ValueError):
        pt.Autocorrelation(8, 2, **F64)(torch.zeros(7, dtype=torch.float64))


@pytest.mark.parametrize("M", [2, 8, 24])
def test_levdur(M):
    x = _rng(1).standard_normal((3, 4, 64))
    r = np.array(dsp.Autocorrelation(64, M)(jnp.asarray(x)))
    want = dsp.LevinsonDurbin(M)(jnp.asarray(r))
    _close(pt.LevinsonDurbin(M, **F64)(torch.as_tensor(r)), want)


def test_levdur_float32_eps():
    """eps defaults to 1e-5 at float32 and 0 at float64, as in JAX."""
    eye = 1e-5 * torch.eye(3, dtype=torch.float32)
    op = pt.LevinsonDurbin(3, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(op.eye, eye)
    assert not pt.LevinsonDurbin(3, **F64).eye.any()
    lpc = pt.LPC(32, 3, device="cpu", dtype=torch.float32)
    torch.testing.assert_close(lpc.levdur.eye, eye)
    assert pt.LPC(32, 3, eps=0.5, **F64).levdur.eye[0, 0] == 0.5


def test_rlevdur_roundtrip():
    x = _rng(2).standard_normal((2, 64))
    r = dsp.Autocorrelation(64, 6)(jnp.asarray(x))
    a = np.array(dsp.LevinsonDurbin(6)(r))
    want = dsp.ReverseLevinsonDurbin(6, n_fft=1024)(jnp.asarray(a))
    op = pt.ReverseLevinsonDurbin(6, n_fft=1024, **F64)
    assert op.phase_factors.dtype == torch.complex128
    _close(op(torch.as_tensor(a)), want)
    r2 = pt.ReverseLevinsonDurbin(6, n_fft=4096, **F64)(torch.as_tensor(a))
    _close(r2, r, rtol=1e-4, atol=1e-6)


def test_rlevdur_float32_keeps_complex():
    op = pt.ReverseLevinsonDurbin(4, n_fft=64, device="cpu",
                                  dtype=torch.float32)
    assert op.phase_factors.dtype == torch.complex64
    assert op.phase_factors.imag.abs().max() > 0.5


@pytest.mark.parametrize("M", [1, 12, 24])
def test_lpc(M):
    x = _rng(3).standard_normal((2, 5, L))
    want = dsp.LPC(L, M)(jnp.asarray(x))
    _close(pt.LPC(L, M, **F64)(torch.as_tensor(x)), want)


def test_norm0_roundtrip():
    a = _rng(4).standard_normal((3, 7, 9))
    a[..., 0] = np.abs(a[..., 0]) + 0.5
    want = dsp.AllPoleToAllZeroDigitalFilterCoefficients(8)(jnp.asarray(a))
    op = pt.AllPoleToAllZeroDigitalFilterCoefficients(8, **F64)
    got = op(torch.as_tensor(a))
    _close(got, want)
    _close(pt.AllZeroToAllPoleDigitalFilterCoefficients(8, **F64)(got), a)
    with pytest.raises(ValueError):
        op(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        pt.AllPoleToAllZeroDigitalFilterCoefficients(-1, device="cpu")


def _coefs(rng, shape, M):
    k = rng.uniform(-0.3, 0.3, shape + (M + 1,)) / (M + 1)
    k[..., 0] = rng.uniform(0.5, 1.5, shape)
    return k


@pytest.mark.parametrize("M,T,kw", [
    (4, 80, {}),
    (4, 80, {"ignore_gain": True}),
    (1, 160, {}),
    (24, 1600, {}),
    (3, 1280, {"chunk_length": 320}),
    (1, 640, {"chunk_length": 160, "warmup_length": 40}),
])
def test_poledf(M, T, kw):
    rng = _rng(5)
    x = rng.standard_normal((2, T))
    a = _coefs(rng, (2, T // 10), M)
    want = jax.jit(dsp.AllPoleDigitalFilter(M, 10, **kw))(jnp.asarray(x),
                                                          jnp.asarray(a))
    got = pt.AllPoleDigitalFilter(M, 10, **kw, **F64)(torch.as_tensor(x),
                                                      torch.as_tensor(a))
    _close(got, want)


def test_poledf_checks():
    with pytest.raises(ValueError):
        pt.AllPoleDigitalFilter(-1, 10, device="cpu")
    with pytest.raises(ValueError):
        pt.AllPoleDigitalFilter(2, 0, device="cpu")
    op = pt.AllPoleDigitalFilter(2, 10, **F64)
    with pytest.raises(ValueError):
        op(torch.zeros(1, 95, dtype=torch.float64),
           torch.ones(1, 10, 3, dtype=torch.float64))


def _jax_chain(x, M):
    frame, window = dsp.Frame(L, P), dsp.Window(L)
    lpc = dsp.LPC(L, M)
    zerodf, poledf = (dsp.AllZeroDigitalFilter(M, P),
                      dsp.AllPoleDigitalFilter(M, P))
    norm0 = dsp.AllPoleToAllZeroDigitalFilterCoefficients(M)
    a = lpc(window(frame(x)))
    T = a.shape[-2] * P
    e = zerodf(x[..., :T], norm0(a))
    return a, e, poledf(e, a)


def _torch_chain(x, M, **kw):
    frame, window = pt.Frame(L, P, **kw), pt.Window(L, **kw)
    lpc = pt.LPC(L, M, **kw)
    zerodf, poledf = (pt.AllZeroDigitalFilter(M, P, **kw),
                      pt.AllPoleDigitalFilter(M, P, **kw))
    norm0 = pt.AllPoleToAllZeroDigitalFilterCoefficients(M, **kw)
    a = lpc(window(frame(x)))
    T = a.shape[-2] * P
    e = zerodf(x[..., :T], norm0(a))
    return a, e, poledf(e, a)


X = synth_speech(2, 3200).astype(np.float64)


@pytest.mark.parametrize("M", [24, 1])
def test_chain_matches_jax(M):
    """configs[1] as bench_all.py builds it, at B=2, T=3,200: LPC
    coefficients, residual and resynthesis."""
    want = jax.jit(_jax_chain, static_argnums=1)(jnp.asarray(X), M)
    got = _torch_chain(torch.as_tensor(X), M, **F64)
    assert got[0].shape == (2, 3200 // P, M + 1)
    for g, w in zip(got, want):
        _close(g, w)
    y = got[2].numpy()
    snr = 10 * np.log10(np.sum(X ** 2) / np.sum((y - X) ** 2))
    assert snr > 30.0


def test_chain_gradient_is_finite():
    x = torch.as_tensor(X[:1, :1600]).requires_grad_(True)
    (_torch_chain(x, 24, **F64)[2] ** 2).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


def test_load_jax_params_lpc_eye():
    """A perturbed Toeplitz regularizer carries across as levdur.eye."""
    eye = 0.01 * np.diag(_rng(6).uniform(0.5, 1.5, 8))
    jl = dsp.LPC(64, 8)
    jl.levdur.params["eye"] = jnp.asarray(eye)
    x = _rng(7).standard_normal((3, 64))
    want = jl(jnp.asarray(x))
    tl = pt.LPC(64, 8, **F64)
    pt.load_jax_params(tl, {"levdur.eye": eye})
    _close(tl(torch.as_tensor(x)), want)
    with pytest.raises(ValueError):
        pt.load_jax_params(tl, {"levdur.eye": eye[:4, :4]})


def test_load_jax_params_rlevdur_phase():
    """The complex phase factors carry across, imaginary part included."""
    jr = dsp.ReverseLevinsonDurbin(4, n_fft=64)
    phase = np.asarray(jr.params["phase_factors"]) * np.exp(0.1j)
    jr.params["phase_factors"] = phase
    a = _rng(8).standard_normal((2, 5))
    a[:, 0] = 1.0
    want = jr(jnp.asarray(a))
    tr = pt.ReverseLevinsonDurbin(4, n_fft=64, **F64)
    pt.load_jax_params(tr, {"phase_factors": phase})
    torch.testing.assert_close(tr.phase_factors,
                               torch.as_tensor(phase, dtype=torch.complex128))
    _close(tr(torch.as_tensor(a)), want)
