"""The port's MDCT family against the JAX package on the CPU: MDCT / IMDCT
and MDST / IMDST at frame lengths 16 and 256 with the sine, vorbis, kbd
and rectangular windows, the inverse with and without ``out_length``, the
learnable basis and window (carried by ``load_jax_params``), and the
Hilbert transform, on numpy input from a seed.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
X = np.random.default_rng(41).standard_normal((2, 1000))


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("window", ["sine", "vorbis", "kbd", "rectangular"])
@pytest.mark.parametrize("L", [16, 256])
@pytest.mark.parametrize("name", ["MDCT", "MDST"])
def test_transform_and_inverse_match_jax(name, L, window, dtype):
    jdt = J_DTYPE[dtype]
    fwd = getattr(dsp, name)(L, window, dtype=jdt)
    inv = getattr(dsp, "I" + name)(L, window, dtype=jdt)
    kw = dict(device="cpu", dtype=dtype)
    x = jnp.asarray(X, jdt)
    c = fwd(x)
    got = getattr(pt, name)(L, window, **kw)(torch.as_tensor(X, dtype=dtype))
    _close(got, c, dtype)
    c_t = torch.tensor(np.asarray(c)).to(dtype)
    t_inv = getattr(pt, "I" + name)(L, window, **kw)
    _close(t_inv(c_t, out_length=X.shape[-1]),
           inv(c, out_length=X.shape[-1]), dtype)
    _close(t_inv(c_t), inv(c), dtype)


def test_perfect_reconstruction():
    kw = dict(device="cpu", dtype=torch.float64)
    x = torch.as_tensor(X)
    for L in (16, 256):
        y = pt.IMDCT(L, **kw)(pt.MDCT(L, **kw)(x), out_length=X.shape[-1])
        torch.testing.assert_close(y, x, rtol=1e-10, atol=1e-10)


def test_learnable_basis_and_window_carry_from_jax():
    rng = np.random.default_rng(42)
    L = 16
    W = dsp.ops.mdct.design_mdt(L, "sine") * (1 + 0.1 * rng.standard_normal(
        (L, L // 2)))
    w = np.sin(np.pi * (np.arange(L) + 0.5) / L) + 0.05 * rng.standard_normal(
        L)
    j = dsp.MDCT(L, learnable=True)
    want = j.mdt.apply({"W": jnp.asarray(W)}, j.window.apply(
        {"window": jnp.asarray(w)}, j.frame(jnp.pad(jnp.asarray(X),
                                                    ((0, 0), (0, L // 2))))))
    t = pt.MDCT(L, learnable=True, device="cpu", dtype=torch.float64)
    assert sorted(n for n, _ in t.named_parameters()) == ["mdt.W",
                                                           "window.window"]
    pt.load_jax_params(t, {"mdt.W": W, "window.window": w})
    got = t(torch.as_tensor(X))
    _close(got, want)
    got.sum().backward()
    assert t.mdt.W.grad is not None and t.window.window.grad is not None
    ti = pt.IMDCT(L, learnable=["basis"], device="cpu", dtype=torch.float64)
    assert [n for n, _ in ti.named_parameters()] == ["imdt.W"]
    with pytest.raises(ValueError):
        pt.MDCT(L, learnable=["frame"], device="cpu")
    with pytest.raises(ValueError):
        pt.MDCT(15, device="cpu")


@pytest.mark.parametrize("L,T", [(64, 50), (63, 63), (8, 12)])
def test_hilbert_matches_jax(L, T):
    x = X[:, :T]
    want = dsp.HilbertTransform(L)(jnp.asarray(x))
    got = pt.HilbertTransform(L, device="cpu", dtype=torch.float64)(
        torch.as_tensor(x))
    assert got.dtype == torch.complex128
    _close(got, want)
    want = dsp.HilbertTransform(L, dim=0)(jnp.asarray(X[:2, :5].T.copy()))
    got = pt.HilbertTransform(L, dim=0, device="cpu", dtype=torch.float64)(
        torch.as_tensor(X[:2, :5].T.copy()))
    _close(got, want)
