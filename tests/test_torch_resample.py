"""The port's resampler and FIR bank against the JAX package on the CPU at
float64.

``Resampler`` takes three paths: an integer downsample (one FIR per input
phase), an integer upsample (one FIR bank, interleaved) and a rational
ratio (a framed matmul); ``fir_correlate`` is a VALID cross-correlation
with a static bank.  Inputs are numpy from a seed.

Tolerance: rtol 1e-5 / atol 1e-8 (tests/utils.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels.fir import fir_correlate as jax_fir_correlate
from diffsptk_tpu.utils.resample import Resampler as JResampler
from diffsptk_tpu.utils.resample import (
    design_resample_kernel as jax_design_resample_kernel,
)
from diffsptk_tpu_torch.kernels.fir import fir_correlate
from diffsptk_tpu_torch.utils.resample import (
    Resampler,
    design_resample_kernel,
    get_resample_params,
)

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("orig,new", [(16000, 8000), (48000, 8000),
                                      (8000, 16000), (22050, 16000)])
@pytest.mark.parametrize("T", [3001, 4000])
def test_resampler_matches_jax(orig, new, T):
    x = np.random.default_rng(T + orig).standard_normal((2, T))
    want = np.asarray(JResampler(orig, new)(jnp.asarray(x)))
    got = Resampler(orig, new, **F64)(torch.as_tensor(x))
    assert got.shape == want.shape == (2, -(-new * T // orig))
    _close(got, want)


def test_resampler_kaiser_fast_on_one_row():
    params = get_resample_params("kaiser_fast")
    x = np.random.default_rng(3).standard_normal(2000)
    want = np.asarray(JResampler(16000, 8000, **params)(jnp.asarray(x)))
    got = Resampler(16000, 8000, **params, **F64)(torch.as_tensor(x))
    _close(got, want)


def test_resampler_identity_and_design():
    x = torch.randn(3, 50, dtype=torch.float64)
    assert Resampler(16000, 16000, **F64)(x) is x
    k, w, o, n = design_resample_kernel(22050, 16000)
    jk, jw, jo, jn = jax_design_resample_kernel(22050, 16000)
    assert (w, o, n) == (jw, jo, jn)
    np.testing.assert_array_equal(k, jk)
    with pytest.raises(ValueError):
        get_resample_params("sinc_best")


def test_fir_correlate_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((4, 48))
    x = rng.standard_normal((3, 2, 700))
    want = np.asarray(jax_fir_correlate(jnp.asarray(x), h))
    got = fir_correlate(torch.as_tensor(x), h)
    assert got.shape == want.shape == (3, 2, 4, 653)
    _close(got, want)
    with pytest.raises(ValueError, match="shorter"):
        fir_correlate(torch.zeros(10, dtype=torch.float64), h)
