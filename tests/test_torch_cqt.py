"""The port's constant-Q transform against the JAX package on the CPU:
the design functions of ``ops/cqt_design.py`` (equal), and CQT / ICQT at
``bench_all.py``'s settings (P=64, 16 kHz, 24 bins: an early downsample
by 16, then two octaves) and at 84 bins with P=96 (seven octaves, odd
periods from the sixth, and a basis padded to the shared FFT length), on
2 x 4,096 samples from a seed.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py).  Each JAX transform is built and run once per module.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu.ops import cqt_design as jd
from diffsptk_tpu_torch.ops import cqt_design as td
from diffsptk_tpu_torch.ops.cqt import basis_overlap_add

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
CASES = {"bench_all": dict(frame_period=64, sample_rate=16000, n_bin=24),
         "84 bins": dict(frame_period=96, sample_rate=16000, n_bin=84)}
X = np.random.default_rng(31).standard_normal((2, 4096))


@pytest.fixture(scope="module")
def jax_cqt():
    """Each case's JAX CQT and ICQT, at both dtypes."""
    out = {}
    for name, kw in CASES.items():
        for dt, jdt in J_DTYPE.items():
            c = dsp.CQT(**kw, dtype=jdt)(jnp.asarray(X, jdt))
            y = dsp.ICQT(**kw, dtype=jdt)(c, out_length=X.shape[-1])
            out[name, dt] = (np.asarray(c), np.asarray(y))
    return out


def _close(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


def test_design_functions_equal():
    freqs = td.cqt_frequencies(24, 32.7, 12, 0.1)
    np.testing.assert_array_equal(freqs, jd.cqt_frequencies(24, 32.7, 12,
                                                            0.1))
    np.testing.assert_array_equal(td.et_relative_bw(12),
                                  jd.et_relative_bw(12))
    alpha = td.relative_bandwidth(freqs)
    np.testing.assert_array_equal(alpha, jd.relative_bandwidth(freqs))
    for window in ("hann", "hamming", "rectangular"):
        assert td.window_bandwidth(window) == jd.window_bandwidth(window)
        got = td.wavelet_lengths(freqs, 16000, window, 1, 0, alpha)
        want = jd.wavelet_lengths(freqs, 16000, window, 1, 0, alpha)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for got, want in zip(td.wavelet(freqs[:12], 1000.0),
                         jd.wavelet(freqs[:12], 1000.0)):
        np.testing.assert_array_equal(got, want)
    for force in (None, 8192):
        got = td.vqt_filter_fft(1000.0, freqs[12:], 1, 1, 1e-2,
                                alpha=alpha[12:], force_n_fft=force)
        want = jd.vqt_filter_fft(1000.0, freqs[12:], 1, 1, 1e-2,
                                 alpha=alpha[12:], force_n_fft=force)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert td.num_two_factors(96) == jd.num_two_factors(96) == 5
    for args in ((8000, 1500.0, 64, 2), (8000, 7000.0, 96, 7)):
        assert td.early_downsample_count(*args) == \
            jd.early_downsample_count(*args)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_cqt_and_icqt_match_jax(jax_cqt, case, dtype):
    c_want, y_want = jax_cqt[case, dtype]
    kw = dict(**CASES[case], device="cpu", dtype=dtype)
    c = pt.CQT(**kw)(torch.as_tensor(X, dtype=dtype))
    assert c.dtype == (torch.complex128 if dtype == torch.float64
                       else torch.complex64)
    _close(c, c_want, dtype)
    y = pt.ICQT(**kw)(torch.tensor(c_want).to(c.dtype),
                      out_length=X.shape[-1])
    _close(y, y_want, dtype)


def test_cqt_shapes_and_one_dimensional_input():
    kw = dict(CASES["bench_all"], device="cpu", dtype=torch.float64)
    cqt, icqt = pt.CQT(**kw), pt.ICQT(**kw)
    x = torch.as_tensor(X)
    c = cqt(x)
    assert c.shape == (2, 64, 24)
    torch.testing.assert_close(cqt(x[1]), c[1], rtol=1e-12, atol=1e-12)
    assert icqt(c).shape == (2, 4096)
    with pytest.raises(ValueError):
        pt.CQT(0, 16000, device="cpu")


@pytest.mark.parametrize("B,N,K,L,hop", [(2, 9, 6, 64, 4), (1, 3, 4, 50, 7),
                                         (3, 1, 2, 16, 8), (2, 40, 24, 512,
                                                            64)])
def test_basis_overlap_add_equals_matmul_then_unframe(B, N, K, L, hop):
    """The ICQT's transposed convolution against the frames it stands for:
    a @ basis, overlap-added by Unframe with a rectangular window."""
    rng = np.random.default_rng(32)
    a = torch.as_tensor(rng.standard_normal((B, N, K)))
    basis = torch.as_tensor(rng.standard_normal((K, L)))
    want = pt.Unframe(L, hop, window="rectangular", norm="none",
                      device="cpu", dtype=torch.float64)(a @ basis)
    torch.testing.assert_close(basis_overlap_add(a, basis, hop), want,
                               rtol=1e-12, atol=1e-12)
