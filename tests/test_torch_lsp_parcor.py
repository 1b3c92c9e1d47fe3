"""The port's LPC-domain conversions against the JAX package on the CPU:
PARCOR (the step-down and step-up recursions with gamma, inverse sine,
log area ratio), line spectral pairs (LPC <-> LSP at even and odd
orders and in every unit, the LSP spectrum, both stability checks),
polynomial roots (Aberth and the companion eigenvalues, compared
sorted, since neither package orders them), the composite sinusoidal
model pair, and LinearInterpolation; the LPC come from the port's LPC of
numpy noise from a seed.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(37)


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _lpc(M, frames=4):
    x = torch.as_tensor(RNG.standard_normal((frames, 256)))
    return pt.LPC(256, M, **F64)(x).numpy()


LPC = {M: _lpc(M) for M in (1, 2, 3, 10, 11, 24)}


def _jax(name, args, kw, x, jdt=jnp.float64):
    """The JAX package's op, jitted (one compile instead of one per
    primitive)."""
    return jax.jit(getattr(dsp, name)(*args, **kw))(jnp.asarray(x, jdt))


def _lsp(M, **kw):
    """The port's LSP of LPC[M] (held to the JAX package's above)."""
    return pt.LinearPredictiveCoefficientsToLineSpectralPairs(M, **kw, **F64)(
        torch.as_tensor(LPC[M])).numpy()


def _run(name, args, kw, x, dtype):
    want = _jax(name, args, kw, x, J_DTYPE[dtype])
    got = getattr(pt, name)(*args, **kw, device="cpu", dtype=dtype)(
        torch.as_tensor(x, dtype=dtype))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M,kw", [(10, {}), (24, {}), (11, dict(gamma=-0.5)),
                                  (10, dict(c=3))])
def test_lpc2par_par2lpc_match_jax(M, kw, dtype):
    got, want = _run("LinearPredictiveCoefficientsToParcorCoefficients",
                     (M,), kw, LPC[M], dtype)
    _close(got, want, dtype)
    k = np.asarray(want)
    got, want = _run("ParcorCoefficientsToLinearPredictiveCoefficients",
                     (M,), kw, k, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fwd,inv", [
    ("ParcorCoefficientsToInverseSine", "InverseSineToParcorCoefficients"),
    ("ParcorCoefficientsToLogAreaRatio", "LogAreaRatioToParcorCoefficients")])
def test_parcor_elementwise_pairs_match_jax(fwd, inv, dtype):
    k = np.asarray(_jax("LinearPredictiveCoefficientsToParcorCoefficients",
                        (10,), {}, LPC[10]))
    got, want = _run(fwd, (10,), {}, k, dtype)
    _close(got, want, dtype)
    got, want = _run(inv, (10,), {}, np.asarray(want), dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("M,kw,dtype", [
    (1, {}, torch.float64), (2, {}, torch.float64), (3, {}, torch.float64),
    (10, {}, torch.float64), (11, {}, torch.float64), (24, {}, torch.float64),
    (10, {}, torch.float32), (24, {}, torch.float32),
    (11, dict(log_gain=True, out_format="hz", sample_rate=16000),
     torch.float64),
    (10, dict(out_format="cycle"), torch.float64)])
def test_lpc2lsp_lsp2lpc_match_jax(M, kw, dtype):
    """lsp2lpc expands the LPC polynomial from its unit-circle roots,
    which loses digits as the order grows: at float32 both packages lie
    5e-6 (M = 10) to 1e-2 (M = 24) from float64 (CPU run), apart by
    rounding of that size, so at float32 it is held to float64 no
    farther than twice the JAX package's float32."""
    got, want = _run("LinearPredictiveCoefficientsToLineSpectralPairs",
                     (M,), kw, LPC[M], dtype)
    _close(got, want, dtype)
    ikw = {("in_format" if k == "out_format" else k): v
           for k, v in kw.items()}
    name = "LineSpectralPairsToLinearPredictiveCoefficients"
    w = np.asarray(want)
    got, want = _run(name, (M,), ikw, w, dtype)
    if dtype == torch.float64:
        _close(got, want)
        if not kw:
            _close(got, LPC[M])                       # the round trip
    else:
        ref = np.asarray(_jax(name, (M,), ikw, w))
        err_jax = np.abs(np.asarray(want) - ref).max()
        assert np.abs(got.numpy() - ref).max() <= 2 * err_jax


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M,kw", [(10, {}), (11, dict(alpha=0.42)),
                                  (10, dict(gamma=-0.5, out_format="db")),
                                  (11, dict(log_gain=True,
                                            out_format="magnitude"))])
def test_lsp2sp_matches_jax(M, kw, dtype):
    w = _lsp(M, log_gain=kw.get("log_gain", False))
    got, want = _run("LineSpectralPairsToSpectrum", (M, 64), kw, w, dtype)
    _close(got, want, dtype)


def test_stability_checks_match_jax():
    a = LPC[10].copy()
    a[:, 1:] *= 3.0                                   # unstable filters
    got, want = _run("LinearPredictiveCoefficientsStabilityCheck", (10,),
                     dict(margin=1e-3), a, torch.float64)
    _close(got, want)
    w = _lsp(10)
    w[:, 3] = w[:, 4] + 0.01                          # out of order
    got, want = _run("LineSpectralPairsStabilityCheck", (10,),
                     dict(rate=0.5, n_iter=3), w, torch.float64)
    _close(got, want)


def _same_roots(got, want, dtype):
    """Each row's roots as sets: every root of one within tolerance of a
    root of the other (neither package orders them)."""
    rtol, atol = TOL[dtype]
    g, w = np.asarray(got)[..., :, None], np.asarray(want)[..., None, :]
    bar = atol + rtol * np.abs(w)
    assert (np.abs(g - w) <= bar).any(-1).all()
    assert (np.abs(g - w) <= bar).any(-2).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["aberth", "eig"])
def test_polynomial_roots_match_jax(method, dtype):
    """Real and complex roots; the polar format is compared as
    r e^{i theta}, since a negative real root's angle may fall on either
    side of the branch cut.  The JAX package's eig runs on the host, the
    port's on the tensor's device."""
    a = LPC[10].copy()
    a[:, 0] = 1.0
    for fmt in ("rectangular", "polar"):
        got, want = _run("PolynomialToRoots", (10,),
                         dict(method=method, out_format=fmt), a, dtype)
        got, want = got.numpy(), np.asarray(want)
        if fmt == "polar":
            got, want = (v.real * np.exp(1j * v.imag) for v in (got, want))
        _same_roots(got, want, dtype)


def test_roots_to_polynomial_matches_jax():
    a = LPC[10].copy()
    a[:, 0] = 1.0
    r = np.asarray(dsp.PolynomialToRoots(10)(jnp.asarray(a)))
    for fmt, x in (("rectangular", r),
                   ("polar", np.abs(r) + 1j * np.angle(r))):
        want = dsp.RootsToPolynomial(10, in_format=fmt)(jnp.asarray(x))
        got = pt.RootsToPolynomial(10, in_format=fmt, **F64)(
            torch.as_tensor(x))
        _close(got.real, np.asarray(want).real)
        _close(got.imag, np.asarray(want).imag)
        _close(got.real, a)                           # the round trip


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_csm_pair_matches_jax(dtype):
    x = RNG.standard_normal((3, 64))
    r = np.asarray(dsp.Autocorrelation(64, 7)(jnp.asarray(x)))
    got, want = _run("AutocorrelationToCompositeSinusoidalModelCoefficients",
                     (7,), {}, r, dtype)
    _close(got, want, dtype)
    got, want = _run("CompositeSinusoidalModelCoefficientsToAutocorrelation",
                     (7,), {}, np.asarray(want), dtype)
    _close(got, want, dtype)
    if dtype == torch.float64:
        _close(got, r)                                # the round trip


def test_linear_interpolation_matches_jax():
    x = RNG.standard_normal((2, 5, 3))
    for P in (1, 3, 80):
        _close(pt.LinearInterpolation(P, **F64)(torch.as_tensor(x)),
               dsp.LinearInterpolation(P)(jnp.asarray(x)))
    _close(pt.LinearInterpolation(3, **F64)(torch.as_tensor(x[0, :, 0])),
           dsp.LinearInterpolation(3)(jnp.asarray(x[0, :, 0])))
    with pytest.raises(ValueError):
        pt.LinearInterpolation(0, **F64)


def test_lsp_float32_search_runs_in_float64():
    """A float32 input's LSP are searched in float64 (ROADMAP C.10): on
    the LPC of 1,920 frames of synthetic speech the JAX package's float32
    search loses a root on a frame (row 6, frame 17), the port's float32
    output stays within 1e-6 of max of float64 on every frame."""
    from chip_smoke import synth_speech

    kw = dict(device="cpu", dtype=torch.float32)
    x = torch.as_tensor(synth_speech(8, 19200))
    a = pt.LPC(400, 24, **kw)(pt.Window(400, **kw)(pt.Frame(400, 80, **kw)(
        x)))
    ref = pt.LinearPredictiveCoefficientsToLineSpectralPairs(24, **F64)(
        a.double())
    got = pt.LinearPredictiveCoefficientsToLineSpectralPairs(24, **kw)(a)
    scale = float(ref.abs().max())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
    j32 = np.asarray(_jax("LinearPredictiveCoefficientsToLineSpectralPairs",
                          (24,), {}, a.numpy(), jnp.float32))
    assert np.abs(j32 - ref.numpy()).max() > 1e-2 * scale
