"""The port's miscellaneous ops against the JAX package on the CPU:
decimation, interpolation and delay (both signs, kept length, another
axis), entropy in three units (with zero and negative entries), the soft
histogram, SNR and segmental SNR, RMSE, flux (every lag sign, the L1
norm, one-dimensional input), zero crossings, group delay and phase from
b, from a and from both (unwrapped too), the Yingram, the median filter
(odd and even lengths, across features, magic numbers), magic-number
interpolation (gaps at the edges and inside) and F0 evaluation in every
format and reduction; their gradients; and the median against
``torch.nanquantile`` on the CPU.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py), except the float32 group delay with ``alpha`` below 1,
whose power |g|^alpha magnifies rounding where g passes near zero: there
the port's float32 is held no farther from the JAX package's float64
than the JAX package's own float32 (read: 3.4e-5 against 1.2e-4, on
values up to 3).  Each JAX reference is jitted and computed once per
case."""

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
from diffsptk_tpu_torch.ops.misc import nan_median

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
RNG = np.random.default_rng(81)
X = synth_speech(2, 480).astype(np.float64)
N = X + 0.05 * RNG.standard_normal(X.shape)
P = RNG.uniform(0.01, 1, (3, 16))
P /= P.sum(-1, keepdims=True)
P0 = P.copy()
P0[0, :4] = 0.0
SPEC = RNG.standard_normal((2, 12, 8))
B = RNG.standard_normal((2, 8))
A = np.concatenate([np.ones((2, 1)), 0.3 * RNG.standard_normal((2, 4))], -1)
SEQ = RNG.standard_normal((2, 30, 3))
SEQ[:, ::5] = 0.0
SEQ[0, :3] = 0.0
SEQ[1, -4:] = 0.0
SEQ[0, 10:16, 1] = 0.0
F0 = np.where(RNG.uniform(size=(3, 50)) < 0.3, 0.0,
              RNG.uniform(80, 300, (3, 50)))
F0B = np.where(RNG.uniform(size=(3, 50)) < 0.3, 0.0,
               F0 * RNG.uniform(0.9, 1.1, (3, 50)))
FR64 = np.stack([X[:, 100:164], X[:, 300:364]], 1)            # (2, 2, 64)

# (class name, constructor args, constructor kwargs, inputs)
CASES = [
    ("Decimation", (3, 1), {}, (X,)),
    ("Decimation", (2,), dict(dim=-2), (SPEC,)),
    ("Interpolation", (3, 1), {}, (X,)),
    ("Interpolation", (2,), dict(dim=1), (SPEC,)),
    ("Delay", (4,), {}, (X,)),
    ("Delay", (4, True), {}, (X,)),
    ("Delay", (-4,), {}, (X,)),
    ("Delay", (-4, True), dict(dim=1), (SPEC,)),
    ("Entropy", ("bit",), {}, (P,)),
    ("Entropy", ("nat",), {}, (P0,)),
    ("Entropy", ("dit",), {}, (P,)),
    ("Histogram", (), dict(n_bin=8, lower_bound=-1, upper_bound=1,
                           norm=True, softness=5e-3), (X,)),
    ("Histogram", (), dict(n_bin=4, softness=0.1), (np.abs(X),)),
    ("SignalToNoiseRatio", (), {}, (X, N)),
    ("SignalToNoiseRatio", (60,), dict(full=True, reduction="none"),
     (X, N)),
    ("SignalToNoiseRatio", (50,), dict(full=True, reduction="sum"),
     (X, N)),
    ("RootMeanSquareError", (), {}, (X, N)),
    ("RootMeanSquareError", ("none",), {}, (X, N)),
    ("RootMeanSquareError", ("sum",), {}, (SPEC, SPEC[::-1])),
    ("Flux", (), dict(lag=1), (SPEC, SPEC[::-1])),
    ("Flux", (), dict(lag=-2, norm=1, reduction="sum"), (SPEC, SPEC[::-1])),
    ("Flux", (), dict(lag=0, reduction="none"), (SPEC, SPEC[::-1])),
    ("Flux", (), dict(reduction="batchmean"), (SPEC,)),
    ("Flux", (), dict(reduction="none"), (X[0],)),
    ("ZeroCrossingAnalysis", (40,), {}, (X,)),
    ("ZeroCrossingAnalysis", (16,), dict(norm=True, softness=1e-2),
     (X[0],)),
    ("GroupDelay", (64,), dict(alpha=0.4, gamma=0.9), (B, A)),
    ("GroupDelay", (64,), {}, (B,)),
    ("GroupDelay", (64,), dict(alpha=0.7), (None, A)),
    ("Phase", (64,), {}, (B, A)),
    ("Phase", (64,), dict(unwrap=True), (B, A)),
    ("Phase", (64,), dict(unwrap=True), (None, A)),
    ("Phase", (64,), {}, (B,)),
    ("Yingram", (64,), dict(sample_rate=16000, lag_min=8, n_bin=5),
     (FR64,)),
    ("Yingram", (64,), dict(sample_rate=16000, lag_min=20, lag_max=50),
     (FR64[0],)),
    ("MedianFilter", (3,), {}, (SEQ,)),
    ("MedianFilter", (4,), dict(across_features=True), (SEQ[0],)),
    ("MedianFilter", (5,), dict(magic_number=0.0), (SEQ,)),
    ("MedianFilter", (6,), dict(magic_number=0.0, across_features=True),
     (SEQ,)),
    ("MedianFilter", (3,), {}, (SEQ[0, :, 0],)),
    ("MagicNumberInterpolation", (), {}, (SEQ,)),
    ("MagicNumberInterpolation", (), {}, (SEQ[1],)),
    ("MagicNumberInterpolation", (), dict(magic_number=0.0),
     (SEQ[0, :, 1],)),
] + [("F0Evaluation", (), dict(reduction=r, out_format=f), (F0, F0B))
     for f in ("f0-rmse-hz", "f0-rmse-cent", "f0-rmse-semitone",
               "vuv-error-rate", "vuv-error-percent", "vuv-macro-f1-score")
     for r in ("mean", "sum", "none")]


def _jax_op(name, args, kw, dtype):
    cls = getattr(dsp, name)
    if "dtype" in inspect.signature(cls).parameters:
        kw = dict(kw, dtype=J_DTYPE[dtype])
    return cls(*args, **kw)


def _run(name, args, kw, inputs, dtype):
    jop = _jax_op(name, args, kw, dtype)
    top = getattr(pt, name)(*args, **kw, device="cpu", dtype=dtype)
    given = [i for i, a in enumerate(inputs) if a is not None]

    def call(*arrays):
        full = [None] * len(inputs)
        for i, a in zip(given, arrays):
            full[i] = a
        return jop(*full)

    want = jax.jit(call)(*(jnp.asarray(inputs[i], J_DTYPE[dtype])
                           for i in given))
    got = top(*(None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), dtype=dtype) for a in inputs))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_matches_jax(case, dtype):
    name, args, kw, inputs = CASES[case]
    got, want = _run(name, args, kw, inputs, dtype)
    rtol, atol = TOL[dtype]
    assert got.dtype == dtype
    if dtype == torch.float32 and kw.get("alpha", 1) < 1:
        _, want64 = _run(name, args, kw, inputs, torch.float64)
        want64 = np.asarray(want64)
        err = np.abs(got.numpy() - want64).max()
        assert err <= np.abs(np.asarray(want) - want64).max(), err
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,args,kw,inputs", [
    ("Histogram", (), dict(n_bin=5, lower_bound=-1, upper_bound=1,
                           softness=0.05), (X[:, :64],)),
    ("ZeroCrossingAnalysis", (16,), dict(softness=0.1), (X[:, :64],)),
    ("GroupDelay", (32,), dict(alpha=0.5, gamma=0.8), (B, A)),
    ("Yingram", (64,), dict(sample_rate=16000, lag_min=8, n_bin=3),
     (FR64,)),
    ("MagicNumberInterpolation", (), {}, (SEQ,)),
    ("MedianFilter", (4,), {}, (SEQ,)),
])
def test_gradient_matches_jax(name, args, kw, inputs):
    """d sum(sin(y)) / d(inputs) at float64 in both packages."""
    jop = _jax_op(name, args, kw, torch.float64)
    n = len(inputs)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(jop(*a))),
                            argnums=tuple(range(n))))(
        *(jnp.asarray(a) for a in inputs))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in inputs]
    top = getattr(pt, name)(*args, **kw, device="cpu", dtype=torch.float64)
    torch.sin(top(*ts)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-8)


def test_nan_median_matches_nanquantile():
    """The sort-based median equals ``torch.nanquantile(y, 0.5)`` on
    windows with and without NaN, of odd and even counts, and gives NaN
    where every value is NaN."""
    y = torch.as_tensor(RNG.standard_normal((50, 7)))
    y[RNG.uniform(size=y.shape) < 0.3] = float("nan")
    y[3] = float("nan")
    for k in (7, 6, 1):
        got = nan_median(y[:, :k])
        want = torch.nanquantile(y[:, :k], 0.5, dim=-1)
        torch.testing.assert_close(got, want, equal_nan=True)
    assert torch.isnan(nan_median(y[3:4]))[0]


def test_checks_raise():
    with pytest.raises(ValueError):
        pt.Decimation(0, device="cpu")
    with pytest.raises(ValueError):
        pt.Histogram(upper_bound=0.0, device="cpu")
    with pytest.raises(ValueError):
        pt.Yingram(64, lag_min=70, device="cpu")
    with pytest.raises(ValueError):
        pt.MedianFilter(3, device="cpu")(torch.zeros(1, 2, 3, 4))
    with pytest.raises(ValueError):
        pt.RMSE("max", device="cpu")(torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError):
        pt.GroupDelay(64, device="cpu")()
