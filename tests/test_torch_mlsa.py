"""Synthesis side of the port against the JAX package on the CPU: the
Taylor cascade (plain twin of the CUDA kernel), gnorm, linear
interpolation, mgc2mgc, the all-zero filter and MLSA / IMLSA.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 (tests/utils.py); the
cascade twins against the Pallas kernels in interpret mode as
tests/test_pallas_mlsa.py holds them: the tap-chunked one at 1e-5
(HIGHEST) and 2e-4 (HIGH) of max|y|, the unchunked one at 2e-4."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu.kernels.mlsa_cascade import (
    lane_aligned_nfft as j_lane_aligned_nfft,
)
from diffsptk_tpu.kernels.mlsa_cascade import (
    taylor_cascade_folded as j_folded,
)
from diffsptk_tpu.kernels.pallas_mlsa import _cascade_pallas_chunked
from diffsptk_tpu.ops.gnorm import (
    GeneralizedCepstrumGainNormalization as JGnorm,
)
from diffsptk_tpu.ops.gnorm import (
    GeneralizedCepstrumInverseGainNormalization as JIgnorm,
)
from diffsptk_tpu.ops.linear_intpl import linear_interpolate as j_intpl
from diffsptk_tpu.ops.mgc2mgc import (
    MelGeneralizedCepstrumToMelGeneralizedCepstrum as JMgc2mgc,
)
from diffsptk_tpu.ops.mglsadf import (
    PseudoInverseMGLSADigitalFilter as JIMLSA,
)
from diffsptk_tpu.ops.mglsadf import PseudoMGLSADigitalFilter as JMLSA
from diffsptk_tpu.ops.zerodf import AllZeroDigitalFilter as JZerodf
from diffsptk_tpu_torch.kernels import mlsa
from diffsptk_tpu_torch.kernels.mlsa_cascade import (
    cascade_plan,
    chunked_geometry,
    lane_aligned_nfft,
    taylor_cascade_chunked,
    taylor_cascade_folded,
    taylor_cascade_unchunked,
)
from diffsptk_tpu_torch.ops.linear_intpl import linear_interpolate

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(21)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _case(B, N, P, M, S, dtype=np.float32):
    x = RNG.standard_normal((B, N * P)).astype(dtype)
    base = RNG.standard_normal((B, 1, M + 1)) * (0.8 ** np.arange(M + 1))
    c = (base * (1 + 0.05 * RNG.standard_normal((B, N, M + 1)))
         * 0.3).astype(dtype)
    weights = (1.0 / np.cumprod([1.0] + list(range(1, S + 1)))).astype(dtype)
    a = np.ones(S + 1, dtype)
    return x, c, weights, a


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_plans_match_jax():
    from diffsptk_tpu.kernels.mlsa_cascade import cascade_plan as j_plan

    for args in [(254, 79, 80, 0), (510, 199, 80, 0), (128, 30, 16, 5)]:
        for got, want in zip(cascade_plan(*args), j_plan(*args)):
            np.testing.assert_array_equal(got, want)
    for n in (100, 240, 359, 360):
        assert lane_aligned_nfft(n) == j_lane_aligned_nfft(n)


@pytest.mark.parametrize("B,N,P,M,S,advance,precision",
                         [(4, 6, 16, 39, 4, 0, "HIGHEST"),
                          (2, 5, 16, 30, 3, 5, "HIGHEST"),
                          (4, 6, 16, 39, 4, 0, "HIGH")])
def test_cascade_twin_matches_pallas_interpret(B, N, P, M, S, advance,
                                               precision):
    """The tap-chunked geometry the kernel takes, against the Pallas
    kernel it replaces."""
    nfft_c = j_lane_aligned_nfft(3 * P)
    x, c, weights, a = _case(B, N, P, M, S)
    want = np.asarray(_cascade_pallas_chunked(
        jnp.asarray(x.reshape(B, N, P)), jnp.asarray(c), jnp.asarray(weights),
        jnp.asarray(a), P, advance, nfft_c, interpret=True,
        precision=precision)).reshape(B, N * P)
    got = taylor_cascade_chunked(*_t(x, c, weights, a), P, advance,
                                 nfft_c).numpy()
    tol = 2e-4 if precision == "HIGH" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("B,N,P,M,S,advance", [(2, 5, 16, 39, 4, 0),
                                               (2, 5, 16, 30, 3, 5),
                                               (1, 4, 16, 239, 3, 0),
                                               (1, 4, 16, 231, 3, 7)])
def test_folded_matches_jax_float64(B, N, P, M, S, advance):
    """Both branches of the folded form: tap-chunked where the chunk
    transform is shorter (M=239 and 231 at P=16)."""
    x, c, weights, a = _case(B, N, P, M, S, np.float64)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    want = j_folded(*map(jnp.asarray, (x, c, weights, a)), P, advance,
                    nfft)
    got = taylor_cascade_folded(*_t(x, c, weights, a), P, advance, nfft)
    _close(got, want)


def test_cascade_entry_and_backward_match_jax():
    """taylor_cascade on the tap-chunked geometry: forward on the CPU is
    the twin (no launch), backward the JAX VJP of the folded form."""
    B, N, P, M, S, advance = 2, 4, 16, 239, 3, 0
    x, c, weights, a = _case(B, N, P, M, S, np.float64)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    assert chunked_geometry(M, P, nfft) is not None
    g = RNG.standard_normal(x.shape)
    _, vjp = jax.vjp(lambda *t: j_folded(*t, P, advance, nfft),
                     *map(jnp.asarray, (x, c, weights, a)))
    want = vjp(jnp.asarray(g))
    ins = [t.requires_grad_(True) for t in _t(x, c, weights, a)]
    launches = mlsa.launches
    y = mlsa.taylor_cascade(*ins, P, advance, nfft)
    assert mlsa.launches == launches      # a CPU tensor runs the twin
    _close(y, j_folded(*map(jnp.asarray, (x, c, weights, a)), P, advance,
                       nfft))
    y.backward(torch.as_tensor(g))
    for t, w in zip(ins, want):
        _close(t.grad, w)


def test_gnorm_and_interpolation():
    c = RNG.standard_normal((3, 5)) * 0.3
    for gamma in (0.0, -0.5):
        _close(pt.GeneralizedCepstrumGainNormalization(4, gamma, **F64)(
            torch.as_tensor(c)), JGnorm(4, gamma)(jnp.asarray(c)))
        k = np.abs(c) + 0.5
        _close(pt.GeneralizedCepstrumInverseGainNormalization(
            4, gamma, **F64)(torch.as_tensor(k)),
            JIgnorm(4, gamma)(jnp.asarray(k)))
    f = RNG.standard_normal((2, 6, 3))
    _close(linear_interpolate(torch.as_tensor(f), 5),
           j_intpl(jnp.asarray(f), 5))
    _close(linear_interpolate(torch.as_tensor(f[0, :, 0]), 4),
           j_intpl(jnp.asarray(f[0, :, 0]), 4))


@pytest.mark.parametrize("kw", [
    dict(in_order=24, out_order=199, in_alpha=0.42),
    dict(in_order=6, out_order=9, in_alpha=0.1, out_alpha=0.3,
         in_gamma=-0.5, out_gamma=-0.25),
    dict(in_order=6, out_order=8, in_gamma=0.0, out_gamma=-0.5,
         out_mul=True),
    dict(in_order=6, out_order=6, in_gamma=-0.5, out_gamma=-0.5,
         in_norm=True, in_mul=True),
])
def test_mgc2mgc(kw):
    mc = RNG.standard_normal((2, 3, kw["in_order"] + 1)) * 0.1
    mc[..., 0] = np.abs(mc[..., 0]) + 1.0
    _close(pt.MelGeneralizedCepstrumToMelGeneralizedCepstrum(**kw, **F64)(
        torch.as_tensor(mc)), JMgc2mgc(**kw)(jnp.asarray(mc)))


@pytest.mark.parametrize("ignore_gain,zeroth", [(False, 0), (True, 0),
                                                (False, 3)])
def test_zerodf_direct(ignore_gain, zeroth):
    x = RNG.standard_normal((2, 40))
    b = RNG.standard_normal((2, 5, 8))
    b[..., 0] += 2.0
    b[..., -1] += 2.0
    kw = dict(ignore_gain=ignore_gain, zeroth_index=zeroth)
    _close(pt.AllZeroDigitalFilter(7, 8, **kw, **F64)(*_t(x, b)),
           JZerodf(7, 8, **kw)(*map(jnp.asarray, (x, b))))
    with pytest.raises(NotImplementedError):
        pt.AllZeroDigitalFilter(40, 8, **F64)(
            torch.zeros(2, 40, dtype=torch.float64),
            torch.zeros(2, 5, 41, dtype=torch.float64))


@pytest.mark.parametrize("cascade", ["folded", "fused"])
def test_mlsa_imlsa_flagship_order(cascade):
    """cep_order=199, P=80, Taylor order 20 on a short signal."""
    B, N, P = 2, 4, 80
    x = RNG.standard_normal((B, N * P))
    mc = RNG.standard_normal((B, N, 25)) * 0.1
    kw = dict(alpha=0.42, cep_order=199, taylor_order=20, cascade=cascade)
    for jcls, tcls in ((JMLSA, pt.MLSA), (JIMLSA, pt.IMLSA)):
        want = jcls(24, P, **kw)(*map(jnp.asarray, (x, mc)))
        _close(tcls(24, P, **kw, **F64)(*_t(x, mc)), want)


@pytest.mark.parametrize("phase", ["maximum", "zero", "mixed"])
def test_mlsa_phases(phase):
    B, N, P = 2, 5, 8
    x = RNG.standard_normal((B, N * P))
    order = 4
    width = 2 * order + 1 if phase == "mixed" else order + 1
    mc = RNG.standard_normal((B, N, width)) * 0.1
    kw = dict(alpha=0.2, cep_order=9, taylor_order=6, phase=phase)
    want = JMLSA(order, P, **kw)(*map(jnp.asarray, (x, mc)))
    _close(pt.MLSA(order, P, **kw, **F64)(*_t(x, mc)), want)


def test_not_ported_paths_raise():
    for mode in ("single-stage", "freq-domain", "pade-approx"):
        with pytest.raises(NotImplementedError):
            pt.MLSA(4, 8, mode=mode, **F64)
    with pytest.raises(NotImplementedError):
        pt.MLSA(4, 8, cascade="stages", **F64)


@pytest.mark.parametrize("B,N,P,M,S,advance",
                         [(2, 6, 16, 39, 4, 0),
                          (1, 5, 16, 30, 3, 5),
                          (3, 4, 32, 63, 6, 0)])
def test_unchunked_twin_matches_pallas_interpret(B, N, P, M, S, advance):
    """The monolithic geometry (B3): the twin of the kernel's unchunked
    entry against the Pallas kernel it replaces, at the shapes and
    tolerance of tests/test_pallas_mlsa.py."""
    from diffsptk_tpu.kernels.pallas_mlsa import _cascade_pallas, _pad128

    nfft = 1 << int(np.ceil(np.log2(2 * P + M + 1)))
    x, c, weights, a = _case(B, N, P, M, S)
    K = nfft // 2 + 1
    cspec = np.fft.rfft(c, n=nfft)
    pad = [(0, 0), (0, 0), (0, _pad128(K) - K)]
    cre = jnp.asarray(np.pad(cspec.real.astype(np.float32), pad))
    cim = jnp.asarray(np.pad(cspec.imag.astype(np.float32), pad))
    want = np.asarray(_cascade_pallas(
        jnp.asarray(x.reshape(B, N, P)), cre, cim, jnp.asarray(weights),
        jnp.asarray(a), P, M, advance, nfft,
        interpret=True)).reshape(B, N * P)
    got = taylor_cascade_unchunked(*_t(x, c, weights, a), P, advance,
                                   nfft).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * float(np.abs(want).max()))


def test_unchunked_plans_pad_the_half_spectrum():
    """The kernel's plans are cascade_plan's, the half spectrum padded
    with zero bins to a multiple of 4 (K = 65 -> 68)."""
    F, Gre, Gim, r0, n_blk, K = mlsa.unchunked_plans(128, 39, 16, 0, "cpu")
    Ffwd, Ginv_re, Ginv_im, r0_, n_blk_ = cascade_plan(128, 39, 16, 0)
    assert (r0, n_blk, K) == (r0_, n_blk_, 65) and F.shape == (n_blk, 16, 136)
    np.testing.assert_allclose(F[..., :65].numpy(), Ffwd[..., :65], atol=1e-7)
    np.testing.assert_allclose(F[..., 68:133].numpy(), Ffwd[..., 65:],
                               atol=1e-7)
    assert not F[..., 65:68].any() and not F[..., 133:].any()
    np.testing.assert_allclose(Gre[:65].numpy(), Ginv_re, atol=1e-7)
    np.testing.assert_allclose(Gim[:65].numpy(), Ginv_im, atol=1e-7)
    assert not Gre[65:].any() and not Gim[65:].any()
    # the 48 kHz geometry: K = 384 needs no padding
    assert mlsa.unchunked_plans(766, 199, 240, 0, "cpu")[0].shape == (
        3, 240, 768)


def test_cascade_entry_unchunked_geometry_and_backward():
    """taylor_cascade where the chunked transform is not smaller (one tap
    chunk, P=240, M=199): a CPU tensor runs the twin, no kernel counts,
    and the backward is the JAX VJP of the folded form."""
    B, N, P, M, S, advance = 1, 3, 240, 199, 3, 0
    x, c, weights, a = _case(B, N, P, M, S, np.float64)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    assert nfft == 766 and chunked_geometry(M, P, nfft) is None
    g = RNG.standard_normal(x.shape)
    j_args = map(jnp.asarray, (x, c, weights, a))
    want_y, vjp = jax.vjp(lambda *t: j_folded(*t, P, advance, nfft), *j_args)
    want = vjp(jnp.asarray(g))
    ins = [t.requires_grad_(True) for t in _t(x, c, weights, a)]
    before = (mlsa.launches, mlsa.launches_unchunked)
    y = mlsa.taylor_cascade(*ins, P, advance, nfft)
    assert (mlsa.launches, mlsa.launches_unchunked) == before
    _close(y, want_y)
    y.backward(torch.as_tensor(g))
    for t, w in zip(ins, want):
        _close(t.grad, w)


def test_mcep_vocoder_48k_matches_jax():
    """MelCepstralVocoder at 48 kHz with 5 ms frames (P=240, 1200-sample
    frames, fft 2048, alpha 0.55): both cascades on the unchunked
    geometry, float64, against the JAX package."""
    from chip_smoke import synth_speech
    from diffsptk_tpu.models.mcep_vocoder import (
        MelCepstralVocoder as JVocoder,
    )

    kw = dict(frame_length=1200, frame_period=240, fft_length=2048,
              cep_order=24, alpha=0.55, n_iter=3, taylor_order=6)
    x = synth_speech(1, 2400, sr=48000).astype(np.float64)
    want = np.asarray(jax.jit(JVocoder(**kw, cascade="fused")
                              .analysis_synthesis)(jnp.asarray(x)))
    got = pt.MelCepstralVocoder(**kw, cascade="fused", **F64)\
        .analysis_synthesis(torch.as_tensor(x))
    _close(got, want)


@pytest.mark.parametrize("taylor_order,converges", [(20, False), (25, True)])
def test_mcep_vocoder_48k_taylor_order_matches_jax(taylor_order, converges):
    """The 48 kHz vocoder (alpha 0.55, 10 Newton steps) at Taylor order 20,
    the default, and 25, on 4,800 samples of synthetic speech at float64:
    the port equals the JAX package, so both share the round trip's SNR,
    which stays below 0 dB at order 20 (the cascade does not converge) and
    rises above 20 dB at order 25."""
    from chip_smoke import synth_speech
    from diffsptk_tpu.models.mcep_vocoder import (
        MelCepstralVocoder as JVocoder,
    )

    kw = dict(frame_length=1200, frame_period=240, fft_length=2048,
              cep_order=24, alpha=0.55, n_iter=10, taylor_order=taylor_order)
    x = synth_speech(1, 4800, sr=48000).astype(np.float64)
    want = np.asarray(jax.jit(JVocoder(**kw, cascade="fused")
                              .analysis_synthesis)(jnp.asarray(x)))
    got = pt.MelCepstralVocoder(**kw, cascade="fused", **F64)\
        .analysis_synthesis(torch.as_tensor(x))
    _close(got, want)
    for y in (got.numpy(), want):
        snr = 10 * np.log10((x ** 2).sum() / ((y - x) ** 2).sum())
        assert (snr > 20.0) if converges else (snr < 0.0), snr
