"""The port's PQMF bank and fractional-octave-band analysis against the
JAX package on the CPU: the filters equal, PQMF / IPQMF at (bands,
order) = (2, 10), (4, 47) and (8, 63) on 1-, 2- and 3-D input, the learnable
filters carried by ``load_jax_params``, the round trip, and
``FractionalOctaveBandAnalysis(16000, filter_order=400)``, on numpy input
from a seed.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py)."""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu.ops.pqmf import make_filter_banks as j_banks
from diffsptk_tpu_torch.ops.pqmf import make_filter_banks as t_banks

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
X = np.random.default_rng(51).standard_normal((2, 2000))


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,M", [(2, 10), (4, 47), (8, 63)])
def test_pqmf_and_ipqmf_match_jax(K, M, dtype):
    jdt = J_DTYPE[dtype]
    kw = dict(device="cpu", dtype=dtype)
    ja, js = dsp.PQMF(K, M, dtype=jdt), dsp.IPQMF(K, M, dtype=jdt)
    ta, ts = pt.PQMF(K, M, **kw), pt.IPQMF(K, M, **kw)
    _close(ta.filters, ja.filters, dtype)
    _close(ts.filters, js.filters, dtype)
    sub = ja(jnp.asarray(X, jdt))
    _close(ta(torch.as_tensor(X, dtype=dtype)), sub, dtype)
    sub_t = torch.tensor(np.asarray(sub)).to(dtype)
    _close(ts(sub_t), js(sub), dtype)
    _close(ts(sub_t, keepdim=False), js(sub, keepdim=False), dtype)
    for x in (X[0], X[:, None, :]):
        _close(ta(torch.as_tensor(x, dtype=dtype)), ja(jnp.asarray(x, jdt)),
               dtype)


@pytest.mark.parametrize("mode", ["analysis", "synthesis"])
def test_filter_design_equal(mode):
    for K, M, kw in ((4, 47, {}), (3, 30, dict(alpha=40)),
                     (2, 20, dict(alpha=10, n_iter=3))):
        got, conv = t_banks(K, M, mode, **kw)
        want, conv_j = j_banks(K, M, mode, **kw)
        np.testing.assert_array_equal(got, want)
        assert conv == conv_j
    for bad in (dict(n_band=0), dict(filter_order=1), dict(n_iter=0),
                dict(alpha=0), dict(step_size=0), dict(decay=0),
                dict(eps=-1)):
        args = dict(n_band=4, filter_order=47) | bad
        with pytest.raises(ValueError):
            t_banks(**args)


def test_unconverged_search_warns():
    with pytest.warns(UserWarning, match="Failed to find PQMF"):
        pt.PQMF(4, 47, n_iter=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt.PQMF(4, 47, device="cpu")


def test_learnable_filters_carry_from_jax():
    rng = np.random.default_rng(52)
    ja = dsp.PQMF(4, 47, learnable=True)
    f = np.asarray(ja.filters) * (1 + 0.05 * rng.standard_normal(
        ja.filters.shape))
    ja.filters = jnp.asarray(f)
    want = ja(jnp.asarray(X))
    ta = pt.PQMF(4, 47, learnable=True, device="cpu", dtype=torch.float64)
    assert [n for n, _ in ta.named_parameters()] == ["filters"]
    pt.load_jax_params(ta, {"filters": f})
    got = ta(torch.as_tensor(X))
    _close(got, want)
    got.sum().backward()
    assert ta.filters.grad is not None
    ts = pt.IPQMF(4, 47, learnable=True, device="cpu")
    assert [n for n, _ in ts.named_parameters()] == ["filters"]


def test_round_trip_interior():
    kw = dict(device="cpu", dtype=torch.float64)
    x = torch.as_tensor(X)
    y = pt.IPQMF(4, 47, **kw)(pt.PQMF(4, 47, **kw)(x))[:, 0]
    e = (y - x)[:, 100:-100]
    snr = 10 * torch.log10((x[:, 100:-100] ** 2).sum() / (e ** 2).sum())
    assert snr > 30.0, snr


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fractional_octave_bands_match_jax(dtype):
    jdt = J_DTYPE[dtype]
    j = dsp.FractionalOctaveBandAnalysis(16000, filter_order=400, dtype=jdt)
    t = pt.FractionalOctaveBandAnalysis(16000, filter_order=400,
                                        device="cpu", dtype=dtype)
    _close(t.filters, j.filters, dtype)
    _close(t(torch.as_tensor(X, dtype=dtype)), j(jnp.asarray(X, jdt)), dtype)
    kw = dict(filter_order=64, n_fract=2, overlap=0.5, f_min=100,
              f_max=4000)
    _close(pt.FractionalOctaveBandAnalysis(
        16000, **kw, device="cpu", dtype=torch.float64)(torch.as_tensor(X)),
        dsp.FractionalOctaveBandAnalysis(16000, **kw)(jnp.asarray(X)))
    with pytest.raises(ValueError):
        pt.FractionalOctaveBandAnalysis(16000, f_max=9000, device="cpu")
