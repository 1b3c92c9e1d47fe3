"""The port's inverse front end against the JAX package on the CPU at
float64: ``Unframe`` (weighted overlap-add), ``ISTFT`` and ``IFFTR``, each
also learnable, and the round trip ``ISTFT(STFT(x))`` at 400/80/512.
Inputs are numpy from a seed.

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


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _x(T=3000, seed=0):
    return np.random.default_rng(seed).standard_normal((2, T))


@pytest.mark.parametrize("L,P,center,window,out_length", [
    (400, 80, True, "rectangular", None),
    (400, 80, True, "hanning", 3000),
    (401, 80, False, "blackman", None),
    (64, 64, True, "hamming", 500),
])
def test_unframe_matches_jax(L, P, center, window, out_length):
    x = _x()
    frames = np.asarray(dsp.Frame(L, P, center=center)(jnp.asarray(x)))
    want = dsp.Unframe(L, P, center=center, window=window)(
        jnp.asarray(frames), out_length=out_length)
    got = pt.Unframe(L, P, center=center, window=window, **F64)(
        torch.tensor(frames), out_length=out_length)
    assert got.shape == want.shape
    _close(got, want)
    with pytest.raises(ValueError):
        pt.Unframe(L, P, **F64)(torch.zeros(3, L + 1, dtype=torch.float64))


def test_unframe_rejects_bad_geometry():
    with pytest.raises(ValueError):
        pt.Unframe(0, 1, **F64)
    with pytest.raises(ValueError):
        pt.Unframe(40, 80, **F64)


@pytest.mark.parametrize("learnable", [False, True, ["window"], ["basis"]])
@pytest.mark.parametrize("out_length", [None, 3000])
def test_istft_matches_jax(learnable, out_length):
    kw = dict(frame_length=400, frame_period=80, fft_length=512)
    S = np.asarray(dsp.STFT(**kw, out_format="complex")(jnp.asarray(_x())))
    want = dsp.ISTFT(**kw, learnable=learnable)(jnp.asarray(S),
                                                out_length=out_length)
    op = pt.ISTFT(**kw, learnable=learnable, **F64)
    got = op(torch.tensor(S), out_length=out_length)
    assert got.shape == want.shape
    _close(got, want)
    n_learn = (2 if learnable is True else 0 if learnable is False
               else len(learnable))
    assert len(list(op.parameters())) == n_learn


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("out_length", [None, 400])
def test_ifftr_matches_jax(learnable, out_length):
    X = np.asarray(dsp.RealValuedFastFourierTransform(512)(
        jnp.asarray(_x(400))))
    want = dsp.IFFTR(512, out_length, learnable=learnable)(jnp.asarray(X))
    got = pt.IFFTR(512, out_length, learnable=learnable, **F64)(
        torch.tensor(X))
    assert got.shape == want.shape
    _close(got, want)
    with pytest.raises(ValueError):
        pt.IFFTR(511, **F64)
    with pytest.raises(ValueError):
        pt.IFFTR(512, 513, **F64)


@pytest.mark.parametrize("dtype,snr_db", [(torch.float64, 200.0),
                                          (torch.float32, 60.0)])
def test_istft_of_stft_round_trip(dtype, snr_db):
    kw = dict(frame_length=400, frame_period=80, fft_length=512)
    x = torch.as_tensor(_x(19200), dtype=dtype)
    S = pt.STFT(**kw, out_format="complex", device="cpu", dtype=dtype)(x)
    y = pt.ISTFT(**kw, device="cpu", dtype=dtype)(S, out_length=19200)
    err = (y - x)[..., :-80]                   # the tail lacks WOLA cover
    snr = 10 * torch.log10((x ** 2).sum() / (err ** 2).sum())
    assert float(snr) > snr_db
