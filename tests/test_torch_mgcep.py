"""Mel-generalized cepstral analysis of the port and the Newton kernel's
two-generator entry, on the CPU against the JAX package: the plain twin
of the (Toeplitz(p) + Hankel(q)) solve against the Pallas kernel in
interpret mode and against a float64 dense solve, its backward against
torch autograd through a dense solve, mgcep at gamma in {-1, -1/2, -1/3,
0} with n_iter in {0, 3}, the [mgc] chain (chip_smoke.mgc_chain), the
second-order all-pass transforms and mel-cepstral analysis, the carry
of JAX arrays, and the kinds of the names both packages export.

Tolerances: 2e-4 (rtol and atol) for the float32 solve, as
tests/test_pallas_newton.py holds the Pallas kernel; 1e-6 / 1e-8 for the
float64 backward; rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at
float32 for the modules (tests/utils.py).  Interpret mode traces the
fully unrolled kernel, so it runs at n = 7 and 12 only; n = 24 and 33
are held against the dense solve."""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import MGC, mgc_chain, synth_speech
from diffsptk_tpu.kernels.pallas_newton import toephank_solve_pallas
from diffsptk_tpu_torch.kernels import newton

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(23)


def _close(got, want, dtype=torch.float64, rtol=None, atol=None):
    r, a = TOL[dtype]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=r if rtol is None else rtol,
                               atol=a if atol is None else atol)


def _system(n, B, dtype=np.float32):
    p = RNG.standard_normal((B, n)).astype(dtype) * 0.1
    p[:, 0] += 4.0 + n * 0.2
    q = RNG.standard_normal((B, 2 * n - 1)).astype(dtype) * 0.1
    b = RNG.standard_normal((B, n)).astype(dtype)
    return p, q, b


def _dense(p, q):
    n = p.shape[-1]
    i = np.arange(n)
    return (p[..., np.abs(i[:, None] - i[None, :])]
            + q[..., i[:, None] + i[None, :]])


@pytest.mark.parametrize("n,B", [(7, 9), (12, 20)])
def test_toephank_twin_matches_pallas_interpret(n, B):
    p, q, b = _system(n, B)
    want = np.asarray(toephank_solve_pallas(
        *map(jnp.asarray, (p, q, b)), interpret=True))
    launches = newton.launches, newton.launches_toephank
    got = newton.toephank_solve(*map(torch.as_tensor, (p, q, b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # a CPU tensor runs the twin
    assert (newton.launches, newton.launches_toephank) == launches


@pytest.mark.parametrize("n,B", [(24, 30), (33, 12)])
def test_toephank_twin_matches_dense_solve(n, B):
    p, q, b = _system(n, B)
    want = np.linalg.solve(_dense(p, q).astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    got = newton.toephank_solve_lane_major(
        *(torch.as_tensor(a.T.copy()) for a in (p, q, b)))
    np.testing.assert_allclose(got.numpy().T, want, rtol=2e-4, atol=2e-4)


def test_toephank_backward_matches_dense_autograd():
    """dp, dq and db of the one-hot contractions against autograd through
    torch.linalg.solve on the assembled matrix, float64."""
    n, B = 9, 12
    p, q, b = _system(n, B, np.float64)
    i = np.arange(n)
    idx_t = torch.as_tensor(np.abs(i[:, None] - i[None, :]))
    idx_h = torch.as_tensor(i[:, None] + i[None, :])
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (p, q, b)]
    p1, q1, b1 = leaves
    want = torch.linalg.solve(p1[:, idx_t] + q1[:, idx_h], b1[..., None])
    torch.sum(torch.sin(want[..., 0])).backward()
    got_leaves = [torch.as_tensor(a).requires_grad_(True) for a in (p, q, b)]
    x = newton.toephank_solve(*got_leaves)
    torch.sum(torch.sin(x)).backward()
    _close(x, want[..., 0].detach(), rtol=1e-6)
    for got, ref in zip(got_leaves, leaves):
        _close(got.grad, ref.grad, rtol=1e-6)


def test_one_generator_entry_is_the_two_generator_solve():
    """mcep's entry is the two-generator solve with p = rt[:n], q = rt."""
    n, B = 8, 6
    _, rt, b = _system(n, B, np.float64)
    rt[:, 0] += 5.0
    rt_t, b_t = torch.as_tensor(rt.T.copy()), torch.as_tensor(b.T.copy())
    torch.testing.assert_close(
        newton.newton_solve_lane_major(rt_t, b_t),
        newton.toephank_solve_lane_major(rt_t[:n], rt_t, b_t), rtol=0,
        atol=0)


def test_toephank_shape_checks():
    with pytest.raises(ValueError):
        newton.toephank_solve_lane_major(torch.zeros(2, 3), torch.zeros(4, 3),
                                         torch.zeros(2, 3))
    with pytest.raises(ValueError):
        newton.toephank_solve_lane_major(torch.zeros(3, 3), torch.zeros(5, 3),
                                         torch.zeros(2, 3))
    with pytest.raises(ValueError):
        newton.toephank_solve(torch.zeros(4, 3), torch.zeros(4, 4),
                              torch.zeros(4, 3))


@pytest.fixture(scope="module")
def spectra():
    """Power spectra of synthetic speech, 2 x 1,600 samples, float64."""
    x = synth_speech(2, 1600).astype(np.float64)
    return np.asarray(dsp.STFT(400, 80, 512, eps=0, relative_floor=-80,
                               out_format="power")(jnp.asarray(x)))


@pytest.mark.parametrize("n_iter", [0, 3])
@pytest.mark.parametrize("gamma", [-1.0, -0.5, -1 / 3, 0.0])
def test_mgcep_matches_jax(spectra, gamma, n_iter):
    kw = dict(fft_length=512, cep_order=24, alpha=0.42, gamma=gamma,
              n_iter=n_iter)
    want = jax.jit(dsp.MelGeneralizedCepstralAnalysis(**kw))(
        jnp.asarray(spectra))
    got = pt.MelGeneralizedCepstralAnalysis(**kw, **F64)(
        torch.as_tensor(spectra))
    _close(got, want)


def test_mgcep_float32_as_close_to_float64_as_jax(spectra):
    """At float32 the Newton systems of a spectrum with an 80 dB floor are
    ill-conditioned: the JAX package's float32 mgcep lies 1.5e-3 from its
    float64 one at gamma = -1/3 (CPU run), beyond the 1e-4 / 1e-6 bar of
    an elementwise comparison, and the port's float32 differs from it by
    rounding of the same size.  So the port's float32 is held to float64
    no farther than twice the JAX package's float32."""
    kw = dict(fft_length=512, cep_order=24, n_iter=3, **MGC)
    sp = spectra.astype(np.float32)
    ref = np.asarray(jax.jit(dsp.MelGeneralizedCepstralAnalysis(**kw))(
        jnp.asarray(spectra)))
    j32 = np.asarray(jax.jit(dsp.MelGeneralizedCepstralAnalysis(
        **kw, dtype=jnp.float32))(jnp.asarray(sp)))
    t32 = pt.MelGeneralizedCepstralAnalysis(
        **kw, device="cpu", dtype=torch.float32)(torch.as_tensor(sp))
    assert t32.dtype == torch.float32
    err_jax = np.abs(j32 - ref).max()
    assert np.abs(t32.numpy() - ref).max() <= 2 * err_jax


def test_mgcep_gradient_matches_jax():
    sp = np.abs(RNG.standard_normal((3, 33))) + 0.1
    kw = dict(fft_length=64, cep_order=6, n_iter=2, **MGC)
    jop = dsp.MelGeneralizedCepstralAnalysis(**kw)
    want = jax.jit(jax.grad(lambda s: jnp.sum(jnp.sin(jop(s)))))(
        jnp.asarray(sp))
    s = torch.as_tensor(sp).requires_grad_(True)
    top = pt.MelGeneralizedCepstralAnalysis(**kw, **F64)
    torch.sum(torch.sin(top(s))).backward()
    _close(s.grad, want, rtol=1e-6, atol=1e-9)


def test_mgcep_carries_jax_arrays(spectra):
    """A JAX mgcep's transform matrices load into the port's by name."""
    kw = dict(fft_length=512, cep_order=24, n_iter=3, **MGC)
    jop = dsp.MelGeneralizedCepstralAnalysis(**kw)
    names = ("cfreqt", "pfreqt", "rfreqt", "ptrans", "qtrans")
    params = {}
    for k, name in enumerate(names):
        a = np.asarray(getattr(jop, name))
        a = a * (1 + 1e-3 * np.cos(np.arange(a.size).reshape(a.shape) + k))
        setattr(jop, name, jnp.asarray(a))
        params[name] = a
    top = pt.MelGeneralizedCepstralAnalysis(**kw, **F64)
    pt.load_jax_params(top, params)
    _close(top(torch.as_tensor(spectra)), jax.jit(jop)(jnp.asarray(spectra)))


def _jax_mgc_chain(x):
    """The [mgc] chain from the JAX package's ops (chip_smoke.mgc_chain)."""
    P = 80
    stft = dsp.STFT(400, P, 512, eps=0, relative_floor=-80,
                    out_format="power")
    mgcep = dsp.MelGeneralizedCepstralAnalysis(
        fft_length=512, cep_order=24, n_iter=10, **MGC)
    fkw = dict(alpha=MGC["alpha"], cep_order=199, taylor_order=20,
               cascade="fused")
    gamma = -1.0 / MGC["c"]
    inverse = dsp.PseudoMGLSADigitalFilter(24, P, gamma=-gamma, **fkw)
    mglsa = dsp.PseudoMGLSADigitalFilter(24, P, gamma=gamma, **fkw)
    mgc = mgcep(stft(x))
    e = inverse(x[..., :mgc.shape[-2] * P], -mgc)
    return mgc, e, mglsa(e, mgc)


@pytest.fixture(scope="module")
def chains():
    x = synth_speech(2, 1600).astype(np.float64)
    want = jax.jit(_jax_mgc_chain)(jnp.asarray(x))
    got = mgc_chain(torch, "cpu", torch.float64)[0](torch.as_tensor(x))
    return x, got, want


def test_mgc_chain_matches_jax(chains):
    """STFT -> mgcep (gamma = -1/3) -> inverse MGLSA -> MGLSA, B=2,
    T=1,600, float64; the round trip above 15 dB (19.3 dB here, CPU run;
    the pseudo inverse's, below, stays under 0 dB)."""
    x, got, want = chains
    for g, w in zip(got, want):
        _close(g, w)
    y = got[2].numpy()
    T = y.shape[-1]
    snr = 10 * np.log10(np.sum(x[:, :T] ** 2)
                        / np.sum((y - x[:, :T]) ** 2))
    assert snr > 15.0


def test_pseudo_inverse_mglsa_inverts_only_at_gamma_zero(chains):
    """PseudoInverseMGLSADigitalFilter negates mgc at the same gamma, in
    both packages; at gamma = -1/3 its round trip does not reconstruct
    (ROADMAP C.9), which is why the [mgc] chain inverts with the MGLSA
    filter at -gamma.  At 16-bit scale (1 + gamma c0 > 0 after the
    negation, so the gain is defined) the port equals the JAX package."""
    x, got, _ = chains
    xs = x * 32768.0
    mgc = mgc_chain(torch, "cpu", torch.float64)[1](torch.as_tensor(xs))
    T = mgc.shape[-2] * 80
    fkw = dict(cep_order=199, taylor_order=20, cascade="fused", **MGC)
    e = pt.IMLSA(24, 80, **fkw, **F64)(torch.as_tensor(xs[:, :T]), mgc)
    y = pt.MLSA(24, 80, **fkw, **F64)(e, mgc)
    want_e = dsp.IMLSA(24, 80, **fkw)(jnp.asarray(xs[:, :T]),
                                      jnp.asarray(mgc.numpy()))
    _close(e, want_e)
    snr = 10 * np.log10(np.sum(xs[:, :T] ** 2)
                        / np.sum((y.numpy() - xs[:, :T]) ** 2))
    assert snr < 0.0


@pytest.mark.parametrize("cls", [
    "SecondOrderAllPassFrequencyTransform",
    "SecondOrderAllPassInverseFrequencyTransform"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_freqt2_matches_jax(cls, dtype):
    c = RNG.standard_normal((3, 13))
    kw = dict(in_order=12, out_order=20, alpha=0.1, theta=0.3, n_fft=256)
    want = getattr(dsp, cls)(**kw, dtype=J_DTYPE[dtype])(
        jnp.asarray(c, J_DTYPE[dtype]))
    got = getattr(pt, cls)(**kw, device="cpu", dtype=dtype)(
        torch.as_tensor(c, dtype=dtype))
    _close(got, want, dtype)


@pytest.mark.parametrize("n_iter", [0, 3])
def test_smcep_matches_jax(spectra, n_iter):
    kw = dict(fft_length=512, cep_order=24, alpha=0.1, theta=0.3,
              n_iter=n_iter, accuracy_factor=2)
    want = jax.jit(dsp.SecondOrderAllPassMelCepstralAnalysis(**kw))(
        jnp.asarray(spectra))
    got = pt.SecondOrderAllPassMelCepstralAnalysis(**kw, **F64)(
        torch.as_tensor(spectra))
    _close(got, want)


def test_smcep_coefficient_transform_and_carry(spectra):
    from diffsptk_tpu.ops.smcep import CoefficientsFrequencyTransform2 as J
    from diffsptk_tpu_torch.ops.smcep import CoefficientsFrequencyTransform2

    c = RNG.standard_normal((2, 9))
    kw = dict(in_order=8, out_order=15, alpha=0.2, theta=0.4, n_fft=128)
    _close(CoefficientsFrequencyTransform2(**kw, **F64)(torch.as_tensor(c)),
           J(**kw)(jnp.asarray(c)))
    kw = dict(fft_length=512, cep_order=10, alpha=0.1, theta=0.3, n_iter=2,
              accuracy_factor=1)
    jop = dsp.SecondOrderAllPassMelCepstralAnalysis(**kw)
    params = {k: np.asarray(v) * 1.001 for k, v in jop.params.items()}
    top = pt.SecondOrderAllPassMelCepstralAnalysis(**kw, **F64)
    pt.load_jax_params(top, params)
    _close(top(torch.as_tensor(spectra)),
           jop.apply({k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(spectra)))


def test_shared_names_are_of_the_same_kind():
    """Every name both packages export is a class in both or a function
    in both."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    shared = public(dsp) & public(pt)
    assert len(shared) >= 94
    for name in ("FFTR", "LinearInterpolation", "ModifiedDiscreteTransform",
                 "InverseModifiedDiscreteTransform",
                 "MelGeneralizedCepstralAnalysis"):
        assert name in shared
    differ = [n for n in sorted(shared)
              if inspect.isclass(getattr(dsp, n))
              != inspect.isclass(getattr(pt, n))
              or inspect.isfunction(getattr(dsp, n))
              != inspect.isfunction(getattr(pt, n))]
    assert not differ, differ
