"""The port's small signal ops against the JAX package on the CPU:
dynamic range compression (its gain loop, 1-D input, gradient and
learnable parameters), A-law, mu-law and uniform quantization (both
quantizers, the straight-through gradient), delta features and MLPG from
coefficient lists and from regression widths, the static IIR filter and
the biquad (pure FIR, true IIR, truncated to ``ir_length``, learnable
coefficients), soft DTW under every local path constraint (distance,
given lengths, gradient, the Viterbi path of the host backtrack), and
``PolynomialToRoots(method="eig")``, whose companion eigenvalues are
computed on the host once per batch.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py); the float32 biquad within 1e-5 of max|y|, since the
JAX package builds its child IIR filter without the dtype, so under x64
its float32 biquad runs in float64 (the port's float32 measured 9e-7 of
max|y| from it).  Roots are compared sorted by angle, then modulus,
since neither package orders them.  Each JAX reference is jitted, or is
the JAX package's own numpy host function."""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu.ops.dtw import _CONSTRAINTS
from diffsptk_tpu.ops.dtw import _viterbi_np as jax_viterbi

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(43)
X = synth_speech(2, 1600).astype(np.float64)


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _pair(name, args, kw, x, dtype):
    """The port's op and the JAX package's (jitted) on the same input at
    ``dtype``; the JAX op takes the dtype where its constructor does."""
    jdt = J_DTYPE[dtype]
    cls = getattr(dsp, name)
    jkw = dict(kw, dtype=jdt) if "dtype" in inspect.signature(
        cls).parameters else kw
    want = jax.jit(cls(*args, **jkw))(jnp.asarray(x, jdt))
    got = getattr(pt, name)(*args, **kw, device="cpu", dtype=dtype)(
        torch.as_tensor(x, dtype=dtype))
    return got, want


CASES = [
    ("DRC", (), dict(sample_rate=16000, threshold=-30, ratio=4), X),
    ("DRC", (), dict(sample_rate=16000, threshold=-12, ratio=2,
                     attack_time=5, release_time=50, makeup_gain=3), X[0]),
    ("ALawCompression", (), {}, X),
    ("ALawCompression", (), dict(abs_max=2.0, a=50.0), X),
    ("ALawExpansion", (), {}, X),
    ("MuLawCompression", (), {}, X),
    ("MuLawExpansion", (), dict(abs_max=0.5, mu=100), X),
    ("UniformQuantization", (), {}, X),
    ("UniformQuantization", (), dict(n_bit=4, quantizer="mid-tread"), X),
    ("InverseUniformQuantization", (), {},
     RNG.integers(0, 256, (2, 40)).astype(np.float64)),
    ("InverseUniformQuantization", (), dict(n_bit=4, quantizer="mid-tread"),
     RNG.integers(0, 15, (2, 40)).astype(np.float64)),
    ("Delta", (), {}, RNG.standard_normal((2, 30, 5))),
    ("Delta", (), dict(seed=[[-0.5, 0.0, 0.5], [1.0, -2.0, 1.0]]),
     RNG.standard_normal((30, 5))),
    ("Delta", (), dict(seed=[[1.0, 2.0], [0.5, 0.0, -0.5, 0.2]],
                       static_out=False), RNG.standard_normal((2, 30, 5))),
    ("Delta", (), dict(seed=[1]), RNG.standard_normal((2, 30, 5))),
    ("Delta", (), dict(seed=[2, 3]), RNG.standard_normal((2, 30, 5))),
    ("MLPG", (30,), {}, RNG.standard_normal((2, 30, 15))),
    ("MLPG", (30,), dict(seed=[1, 1]), RNG.standard_normal((30, 6))),
    ("IIR", (), dict(b=[1.0, -0.5, 0.25]), X),
    ("IIR", (), dict(b=[1.0, -0.5], a=[1.0, -0.9]), X),
    ("IIR", (), dict(b=[1.0, 0.3, 0.2], a=[1.0, -1.2, 0.5]), X),
    ("IIR", (), dict(a=[1.0, -0.9], ir_length=20), X),
    ("SecondOrderDigitalFilter", (16000,),
     dict(pole_frequency=1000, pole_bandwidth=200), X),
    ("SecondOrderDigitalFilter", (16000,),
     dict(pole_frequency=1000, pole_bandwidth=200, zero_frequency=3000,
          zero_bandwidth=300), X),
    ("SecondOrderDigitalFilter", (16000,),
     dict(zero_frequency=3000, zero_bandwidth=300, ir_length=16), X),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_matches_jax(case, dtype):
    name, args, kw, x = CASES[case]
    got, want = _pair(name, args, kw, x, dtype)
    if dtype == torch.float32 and name == "SecondOrderDigitalFilter":
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("name,kw", [
    ("DRC", dict(sample_rate=16000, threshold=-30, ratio=4)),
    ("UniformQuantization", dict(n_bit=4)),
    ("MuLawCompression", {}),
    ("SecondOrderDigitalFilter", dict(sample_rate=16000,
                                      pole_frequency=1000,
                                      pole_bandwidth=200))])
def test_gradient_matches_jax(name, kw):
    """Straight through the quantizer's floor; through DRC's gain loop
    and the biquad's recurrence."""
    jop = getattr(dsp, name)(**kw)
    w = np.cos(np.arange(X.shape[-1]) / 5.0)
    want = jax.jit(jax.grad(lambda x: jnp.sum(jop(x) * w)))(jnp.asarray(X))
    x = torch.as_tensor(X).requires_grad_(True)
    torch.sum(getattr(pt, name)(**kw, **F64)(x)
              * torch.as_tensor(w)).backward()
    _close(x.grad, want)


def test_drc_parameters_are_learnable_and_carry():
    kw = dict(sample_rate=16000, threshold=-30, ratio=4, learnable=True)
    top = pt.DRC(**kw, **F64)
    assert [n for n, _ in top.named_parameters()] == ["params"]
    jop = dsp.DRC(**kw)
    p = np.asarray(jop.params["params"]) * np.array([1.1, 1.2, 0.9, 1.1, 1.0])
    jop.params["params"] = jnp.asarray(p)
    pt.load_jax_params(top, {"params": p})
    _close(top(torch.as_tensor(X)), jax.jit(jop)(jnp.asarray(X)))


def test_iir_learnable_coefficients():
    """Only the polynomials given become parameters; the impulse response
    of a truncated filter is ``b``."""
    f = pt.IIR(b=[1.0, -0.5], a=[1.0, -0.9], learnable=True, **F64)
    assert sorted(n for n, _ in f.named_parameters()) == ["a", "b"]
    f = pt.IIR(a=[1.0, -0.9], learnable=True, **F64)
    assert [n for n, _ in f.named_parameters()] == ["a"]
    f = pt.IIR(b=[1.0, -0.5], a=[1.0, -0.9], ir_length=8, learnable=True,
               **F64)
    assert [n for n, _ in f.named_parameters()] == ["b"]
    y = f(torch.as_tensor(X))
    y.sum().backward()
    assert torch.isfinite(f.b.grad).all()


def test_mlpg_smooths_a_static_trajectory():
    """Means with zero deltas give the static trajectory back where it
    is constant."""
    T = 20
    mean = np.zeros((T, 3))
    mean[:, 0] = 2.0
    y = pt.MLPG(T, **F64)(torch.as_tensor(mean))
    torch.testing.assert_close(y, torch.full((T, 1), 2.0,
                                             dtype=torch.float64))


DTW_X = RNG.standard_normal((2, 7, 3))
DTW_Y = RNG.standard_normal((2, 5, 3))


@pytest.mark.parametrize("p,metric", [(p, "euclidean")
                                      for p in sorted(_CONSTRAINTS)]
                         + [(2, "manhattan"), (6, "squared-euclidean")])
def test_dtw_matches_jax(p, metric):
    jop = dsp.DTW(metric=metric, p=p)
    want = jax.jit(jop)(jnp.asarray(DTW_X), jnp.asarray(DTW_Y))
    got = pt.DTW(metric=metric, p=p, **F64)(torch.as_tensor(DTW_X),
                                            torch.as_tensor(DTW_Y))
    _close(got, want)


@pytest.mark.parametrize("p", [4, 5])
def test_dtw_lengths_gradient_and_path(p):
    """Given lengths, the gradient of the distance, and the Viterbi path
    of the port's host backtrack equal to the JAX package's."""
    lengths = np.array([[7, 5], [6, 5]])
    x = np.abs(DTW_X) + 0.1
    y = np.abs(DTW_Y) + 0.1
    jop = dsp.DTW(metric="symmetric-kl", p=p)
    want, grad = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(jop(a, jnp.asarray(y), lengths))))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    top = pt.DTW(metric="symmetric-kl", p=p, **F64)
    dist, paths = top(xt, torch.as_tensor(y), lengths, return_indices=True)
    dist.sum().backward()
    _close(dist.sum(), want)
    _close(xt.grad, grad)
    D = np.sum((x[:, :, None] - y[:, None]) * (np.log(x[:, :, None])
                                               - np.log(y[:, None])), -1)
    steps, two_step = _CONSTRAINTS[p]
    for got, ref in zip(paths, jax_viterbi(D, lengths, steps, two_step)):
        np.testing.assert_array_equal(got.numpy(), ref)
    merged = pt.DTW.merge(torch.as_tensor(x[0]), torch.as_tensor(y[0]),
                          paths[0])
    assert merged.shape == (len(paths[0]), 6)


def test_dtw_float32_matches_jax():
    jop = dsp.DTW(p=4)
    want = jax.jit(jop)(jnp.asarray(DTW_X, jnp.float32),
                        jnp.asarray(DTW_Y, jnp.float32))
    got = pt.DTW(p=4, device="cpu", dtype=torch.float32)(
        torch.as_tensor(DTW_X, dtype=torch.float32),
        torch.as_tensor(DTW_Y, dtype=torch.float32))
    _close(got, want, torch.float32)


def _sorted_roots(r):
    """Roots in a fixed order: by angle, then modulus (a real root's
    rounding-level imaginary part taken as zero)."""
    r = np.asarray(r)
    r = np.where(np.abs(r.imag) < 1e-12, r.real + 0j, r)
    order = np.lexsort((np.abs(r), np.angle(r)), axis=-1)
    return np.take_along_axis(r, order, axis=-1)


def _polys(M, frames=6):
    x = torch.as_tensor(RNG.standard_normal((frames, 256)))
    a = pt.LPC(256, M, **F64)(x).numpy()
    a[:, 0] = 1.0
    return a


@pytest.mark.parametrize("M", [2, 10, 24])
def test_eig_roots_match_jax(M):
    """The companion eigenvalues, computed on the host once per batch,
    against the JAX package's host callback at float64."""
    a = _polys(M)
    want = dsp.PolynomialToRoots(M, method="eig")(jnp.asarray(a))
    got = pt.PolynomialToRoots(M, method="eig", **F64)(torch.as_tensor(a))
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    np.testing.assert_allclose(_sorted_roots(got.numpy()),
                               _sorted_roots(want), rtol=1e-5, atol=1e-8)


def test_eig_roots_float32_and_complex_input():
    a = _polys(10)
    got = pt.PolynomialToRoots(10, method="eig", device="cpu",
                               dtype=torch.float32)(
        torch.as_tensor(a, dtype=torch.float32))
    want = dsp.PolynomialToRoots(10, method="eig")(
        jnp.asarray(a, jnp.float32))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(_sorted_roots(got.numpy()),
                               _sorted_roots(want), rtol=1e-4, atol=1e-6)
    c = a * np.exp(1j * RNG.uniform(0, 1, a.shape))
    got = pt.PolynomialToRoots(10, method="eig", **F64)(torch.as_tensor(c))
    want = dsp.PolynomialToRoots(10, method="eig")(jnp.asarray(c))
    np.testing.assert_allclose(_sorted_roots(got.numpy()),
                               _sorted_roots(want), rtol=1e-5, atol=1e-8)
