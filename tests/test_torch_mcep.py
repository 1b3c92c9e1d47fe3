"""Port freqt, coefficient freqt, the masked Cholesky solve and
mel-cepstral analysis against the JAX package, float64 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu.ops.freqt import FrequencyTransform as JFreqt
from diffsptk_tpu.ops.mcep import CoefficientsFrequencyTransform as JCoef
from diffsptk_tpu.ops.mcep import MelCepstralAnalysis as JMcep
from diffsptk_tpu.ops.stft import ShortTimeFourierTransform as JSTFT
from diffsptk_tpu.utils.linalg import spd_solve as jspd_solve
from diffsptk_tpu_torch.utils.linalg import spd_solve

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m1,m2,alpha", [(2, 3, 0.3), (24, 199, -0.42),
                                         (10, 4, 0.1)])
def test_freqt(m1, m2, alpha):
    c = np.random.default_rng(0).standard_normal((3, m1 + 1))
    _close(pt.FrequencyTransform(m1, m2, alpha, **F64)(torch.as_tensor(c)),
           JFreqt(m1, m2, alpha)(jnp.asarray(c)))


def test_coef_freqt():
    c = np.random.default_rng(1).standard_normal((4, 257))
    _close(pt.CoefficientsFrequencyTransform(256, 48, 0.42, **F64)(
        torch.as_tensor(c)), JCoef(256, 48, 0.42)(jnp.asarray(c)))


@pytest.mark.parametrize("n,batch", [(6, 20), (25, 4), (25, 30), (3, 2)])
def test_spd_solve(n, batch):
    """Both branches (batch-minor unroll, masked sweeps)."""
    rng = np.random.default_rng(2)
    G = rng.standard_normal((batch, n, n))
    A = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    b = rng.standard_normal((batch, n))
    _close(spd_solve(torch.as_tensor(A), torch.as_tensor(b)),
           jspd_solve(jnp.asarray(A), jnp.asarray(b)))


@pytest.mark.parametrize("n_iter", [0, 10])
def test_mcep_flagship_config(n_iter):
    """M=24, alpha=0.42 on the STFT power spectrum of the vocoder."""
    x = np.random.default_rng(3).standard_normal((2, 1600))
    sp = np.asarray(JSTFT(400, 80, 512, eps=0, relative_floor=-80,
                          out_format="power")(jnp.asarray(x)))
    kw = dict(fft_length=512, cep_order=24, alpha=0.42, n_iter=n_iter)
    want = jax.jit(JMcep(**kw))(jnp.asarray(sp))
    got = pt.MelCepstralAnalysis(**kw, **F64)(torch.tensor(sp))
    _close(got, want)


def test_mcep_gradient_matches_jax():
    sp = np.abs(np.random.default_rng(4).standard_normal((3, 33))) + 0.1
    kw = dict(fft_length=64, cep_order=6, alpha=0.3, n_iter=3)
    jop = JMcep(**kw)
    want = jax.jit(jax.grad(lambda s: jnp.sum(jnp.sin(jop(s)))))(
        jnp.asarray(sp))
    s = torch.as_tensor(sp).requires_grad_(True)
    torch.sum(torch.sin(pt.MelCepstralAnalysis(**kw, **F64)(s))).backward()
    _close(s.grad, want, rtol=1e-6, atol=1e-9)
