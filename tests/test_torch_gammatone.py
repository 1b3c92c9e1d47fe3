"""The port's gammatone filterbank, chroma filterbank and Griffin-Lim
against the JAX package on the CPU: gammatone analysis (fast and exact
modes, its design's 30 bands at 16 kHz, its gradient), synthesis and the
round trip; chroma in both norms; Griffin-Lim at 3 iterations on a short
signal, from a random initial phase that is JAX's
``jax.random.uniform`` (the port's ``utils/prng.uniform``) at float64
and at float32, and from zeros.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py), except where the JAX package's float32 is not float32:
its gammatone analysis keeps the design's poles complex128 (the
constructor takes no dtype), so a float32 input runs in complex128
there, while the port's float32 runs complex64; its Griffin-Lim builds
the STFT and ISTFT without the dtype, so only the initial phase is
float32 there.  Those are held within a bar of max|y|: gammatone 1e-5
(the port's float32 measured at most 2.2e-6 of max|y| from the JAX
package's), Griffin-Lim 1e-4 (three iterations from a zero phase
measured 1.1e-5; the port's own float32 lies 1.4e-5 from its float64).
Each JAX reference is jitted."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu.ops.gammatone import design_gammatone as jax_design
from diffsptk_tpu_torch.ops.gammatone import design_gammatone
from diffsptk_tpu_torch.utils import prng

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
F64 = dict(device="cpu", dtype=torch.float64)
X = synth_speech(2, 1600).astype(np.float64)
SP = np.asarray(dsp.STFT(400, 80, 512)(jnp.asarray(X)))
OF_MAX = 1e-5
GRIFFIN_OF_MAX = 1e-4


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_of_max(got, want, bar=OF_MAX):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= bar * np.abs(want).max(), err / np.abs(want).max()


def test_design_has_30_bands_at_16k():
    d, j = design_gammatone(16000), jax_design(16000)
    assert d["a_tilde"].shape == (30,)
    for key in ("a_tilde", "K", "center_frequencies"):
        np.testing.assert_array_equal(d[key], j[key])
    d, j = design_gammatone(16000, exact=True), jax_design(16000, exact=True)
    np.testing.assert_array_equal(d["b"], j["b"])
    np.testing.assert_array_equal(d["K"], j["K"])


@pytest.mark.parametrize("exact", [False, True])
def test_analysis_matches_jax(exact):
    want = jax.jit(dsp.GammatoneFilterBankAnalysis(16000, exact=exact))(
        jnp.asarray(X))
    got = pt.GammatoneFilterBankAnalysis(16000, exact=exact, **F64)(
        torch.as_tensor(X))
    assert got.dtype == torch.complex128 and got.shape == (2, 30, 1600)
    _close(got, want)
    got32 = pt.GammatoneFilterBankAnalysis(
        16000, exact=exact, device="cpu", dtype=torch.float32)(
        torch.as_tensor(X, dtype=torch.float32))
    assert got32.dtype == torch.complex64
    _close_of_max(got32, jax.jit(dsp.GammatoneFilterBankAnalysis(
        16000, exact=exact))(jnp.asarray(X, jnp.float32)))


def test_analysis_takes_1d_and_3d_input():
    op = pt.GammatoneFilterBankAnalysis(16000, **F64)
    x = torch.as_tensor(X)
    y = op(x)
    torch.testing.assert_close(op(x[0]), y[:1])
    torch.testing.assert_close(op(x[:, None]), y)
    with pytest.raises(ValueError):
        op(x[None, None])


def test_analysis_gradient_matches_jax():
    jop = dsp.GammatoneFilterBankAnalysis(16000)
    w = np.cos(np.arange(1600) / 7.0)
    want = jax.jit(jax.grad(
        lambda x: jnp.sum(jnp.abs(jop(x)) ** 2 * w)))(jnp.asarray(X))
    x = torch.as_tensor(X).requires_grad_(True)
    y = pt.GammatoneFilterBankAnalysis(16000, **F64)(x)
    torch.sum(torch.abs(y) ** 2 * torch.as_tensor(w)).backward()
    _close(x.grad, want)


@pytest.fixture(scope="module")
def subbands():
    return np.asarray(jax.jit(dsp.GammatoneFilterBankAnalysis(16000))(
        jnp.asarray(X)))


@pytest.mark.parametrize("keepdim,compensate", [(True, True),
                                                (False, False)])
def test_synthesis_matches_jax(subbands, keepdim, compensate):
    jop = dsp.GammatoneFilterBankSynthesis(16000)
    want = jax.jit(lambda y: jop(y, keepdim, compensate))(
        jnp.asarray(subbands))
    top = pt.GammatoneFilterBankSynthesis(16000, **F64)
    got = top(torch.as_tensor(subbands), keepdim, compensate)
    _close(got, want)
    top32 = pt.GammatoneFilterBankSynthesis(16000, device="cpu",
                                            dtype=torch.float32)
    jop32 = dsp.GammatoneFilterBankSynthesis(16000, dtype=jnp.float32)
    _close_of_max(
        top32(torch.as_tensor(subbands, dtype=torch.complex64), keepdim,
              compensate),
        jax.jit(lambda y: jop32(y, keepdim, compensate))(
            jnp.asarray(subbands, jnp.complex64)))


def test_round_trip():
    """Analysis then synthesis gives the signal back, delayed by the
    design and compensated: above 15 dB on the interior at float64 (18.4
    dB measured, the JAX package's too; the design does not invert
    exactly)."""
    x = torch.as_tensor(X)
    y = pt.GammatoneFilterBankSynthesis(16000, **F64)(
        pt.GammatoneFilterBankAnalysis(16000, **F64)(x))[:, 0]
    inner = slice(200, 1400)
    snr = 10 * torch.log10((x[:, inner] ** 2).sum()
                           / ((y[:, inner] - x[:, inner]) ** 2).sum())
    assert snr > 15, snr


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kw", [{}, dict(norm=2, use_power=False)])
def test_chroma_matches_jax(kw, dtype):
    jdt = J_DTYPE[dtype]
    args = dict(fft_length=512, n_channel=12, sample_rate=16000, **kw)
    want = jax.jit(dsp.ChromaFilterBankAnalysis(**args, dtype=jdt))(
        jnp.asarray(SP, jdt))
    got = pt.ChromaFilterBankAnalysis(**args, device="cpu", dtype=dtype)(
        torch.as_tensor(SP, dtype=dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_griffin_initial_phase_is_jax_uniform(dtype):
    top = pt.GriffinLim(400, 80, 512, seed=7, device="cpu", dtype=dtype)
    s = torch.ones(2, 21, 257, dtype=dtype)
    got = top.phase_generator(s)
    want = 2 * jnp.pi * jax.random.uniform(jax.random.PRNGKey(7), s.shape,
                                           J_DTYPE[dtype])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    draw = prng.uniform(prng.PRNGKey(7), s.shape, dtype)
    torch.testing.assert_close(got, 2 * math.pi * draw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("init_phase", ["random", "zeros"])
def test_griffin_matches_jax(init_phase, dtype):
    jdt = J_DTYPE[dtype]
    kw = dict(n_iter=3, init_phase=init_phase)
    jop = dsp.GriffinLim(400, 80, 512, **kw, dtype=jdt)
    want = jax.jit(lambda y: jop(y, out_length=1600))(jnp.asarray(SP, jdt))
    got = pt.GriffinLim(400, 80, 512, **kw, device="cpu", dtype=dtype)(
        torch.as_tensor(SP, dtype=dtype), out_length=1600)
    assert got.shape == (2, 1600)
    if dtype == torch.float64:
        _close(got, want)
    else:
        _close_of_max(got, want, GRIFFIN_OF_MAX)
