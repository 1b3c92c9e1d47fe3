"""The port's speech-feature front end against the JAX package on the
CPU: ``plateau``, the auditory scales, the DCT family (DCT, DST, DHT of
types 1-4 and their inverses, the WHT in its three orders), and the
filterbank family (FBANK on triangular and ERB weights, IFBANK, MFCC
and PLP, including PLP at order 24 and 40 channels, which takes the plain
SPD solve here and the solve kernel on the card), their gradients, the
carry of learnable filterbank weights, and the names both packages
share.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py), but float32 MFCC and PLP within 1e-4 of max|y|: the
JAX package builds their filterbank, DCT, Levinson-Durbin and mgc2mgc
children without the dtype, so under x64 its float32 MFCC and PLP run in
float64, while the port's run float32 throughout.  Against the JAX
package the port's float32 then lies up to 1.2e-5 (absolute) away, on
outputs of magnitude 1 to 10; each element's relative bar fails only
where a coefficient passes near zero.  Each JAX reference is jitted."""

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
from diffsptk_tpu.utils import linalg as jlinalg
from diffsptk_tpu.utils import scales as jscales
from diffsptk_tpu_torch.kernels import solve
from diffsptk_tpu_torch.utils import linalg, scales

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
F64 = dict(device="cpu", dtype=torch.float64)
RNG = np.random.default_rng(41)
X16 = RNG.standard_normal((3, 16))
# the power spectra of 400-sample frames of synthetic speech (2 x 11)
SP = np.asarray(dsp.STFT(400, 80, 512)(jnp.asarray(
    synth_speech(2, 800).astype(np.float64))))

NEW_NAMES = (
    "ALawCompression", "ALawExpansion", "BaseNonFunctionalOp",
    "ChromaFilterBankAnalysis", "DCT", "DHT", "DRC", "DST", "DTW", "Delta",
    "DiscreteCosineTransform", "DiscreteHartleyTransform",
    "DiscreteSineTransform", "DynamicRangeCompression",
    "DynamicTimeWarping", "FBANK", "GammatoneFilterBankAnalysis",
    "GammatoneFilterBankSynthesis", "GriffinLim", "IDCT", "IDHT", "IDST",
    "IFBANK", "IIR", "IWHT", "InfiniteImpulseResponseDigitalFilter",
    "InverseDiscreteCosineTransform", "InverseDiscreteHartleyTransform",
    "InverseDiscreteSineTransform", "InverseMelFilterBankAnalysis",
    "InverseUniformQuantization", "InverseWalshHadamardTransform", "MFCC",
    "MLPG", "MaximumLikelihoodParameterGeneration",
    "MelFilterBankAnalysis", "MelFrequencyCepstralCoefficientsAnalysis",
    "MuLawCompression", "MuLawExpansion", "PLP",
    "PerceptualLinearPredictiveCoefficientsAnalysis",
    "SecondOrderDigitalFilter", "UniformQuantization", "WHT",
    "WalshHadamardTransform")


def _close(got, want, dtype=torch.float64):
    rtol, atol = TOL[dtype]
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, dtype)
        return
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


@pytest.mark.parametrize("args", [(5, 1.0, 2.0), (5, 1.0, 2.0, 3.0),
                                  (1, 0.5, 4.0), (4, 2, 2, 1)])
def test_plateau_matches_jax(args):
    np.testing.assert_array_equal(linalg.plateau(*args),
                                  jlinalg.plateau(*args))


@pytest.mark.parametrize("scale", ["htk", "mel", "oshaughnessy",
                                   "inverted-mel", "chakroborty", "bark",
                                   "traunmuller", "linear"])
def test_scales_match_jax(scale):
    f = np.linspace(0, 4000, 17)
    z = scales.hz_to_auditory(f, scale)
    np.testing.assert_array_equal(z, jscales.hz_to_auditory(f, scale))
    np.testing.assert_array_equal(scales.auditory_to_hz(z, scale),
                                  jscales.auditory_to_hz(z, scale))
    with pytest.raises(ValueError):
        scales.hz_to_auditory(f, "erb")


DCT_CASES = [
    ("DCT", (16,), dict(dct_type=t)) for t in (1, 2, 3, 4)] + [
    ("IDCT", (16,), dict(dct_type=t)) for t in (1, 2, 3, 4)] + [
    ("DST", (16,), dict(dst_type=t)) for t in (1, 2, 3, 4)] + [
    ("IDST", (16,), dict(dst_type=t)) for t in (1, 2, 3, 4)] + [
    ("DHT", (16,), dict(dht_type=t)) for t in (1, 2, 3, 4)] + [
    ("IDHT", (16,), dict(dht_type=t)) for t in (1, 2, 3, 4)] + [
    ("WHT", (16,), dict(wht_type=t))
    for t in ("sequency", "natural", "dyadic")] + [
    ("IWHT", (16,), {}), ("DCT", (), dict(dct_length=16))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(len(DCT_CASES)))
def test_dct_family_matches_jax(case, dtype):
    name, args, kw = DCT_CASES[case]
    got, want = _pair(name, args, kw, X16, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("fwd,inv,kw", [
    ("DCT", "IDCT", dict(dct_type=2)), ("DST", "IDST", dict(dst_type=1)),
    ("DHT", "IDHT", dict(dht_type=4)), ("WHT", "IWHT", {})])
def test_dct_family_round_trips(fwd, inv, kw):
    x = torch.as_tensor(X16)
    y = getattr(pt, inv)(16, **kw, **F64)(getattr(pt, fwd)(16, **kw, **F64)(x))
    torch.testing.assert_close(y, x)


def test_dct_family_rejects():
    with pytest.raises(ValueError):
        pt.DCT(0, device="cpu")
    with pytest.raises(ValueError):
        pt.DST(8, dst_type=5, device="cpu")
    with pytest.raises(ValueError):
        pt.WHT(12, device="cpu")
    with pytest.raises(ValueError):
        pt.DCT(8, device="cpu")(torch.zeros(3, 9))


FB = dict(fft_length=512, sample_rate=16000)
FBANK_CASES = [
    ("FBANK", dict(n_channel=20, **FB)),
    ("FBANK", dict(n_channel=24, f_min=100, f_max=7000, gamma=-0.5,
                   scale="mel", use_power=True, out_format="yE", **FB)),
    ("FBANK", dict(n_channel=20, erb_factor=1.0, scale="bark",
                   out_format="y,E", **FB)),
    ("MFCC", dict(mfcc_order=12, n_channel=20, lifter=22, **FB)),
    ("MFCC", dict(mfcc_order=12, n_channel=20, lifter=22, out_format="ycE",
                  **FB)),
    ("PLP", dict(plp_order=12, n_channel=20, lifter=22, **FB)),
    ("PLP", dict(plp_order=12, n_channel=20, lifter=22, out_format="yc",
                 compression_factor=0.5, **FB)),
    ("PLP", dict(plp_order=24, n_channel=40, lifter=22, out_format="ycE",
                 **FB)),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", range(len(FBANK_CASES)))
def test_fbank_family_matches_jax(case, dtype):
    name, kw = FBANK_CASES[case]
    got, want = _pair(name, (), kw, SP, dtype)
    if dtype == torch.float32 and name in ("MFCC", "PLP"):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), err
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ifbank_matches_jax(dtype):
    kw = dict(n_channel=20, **FB)
    y = np.asarray(dsp.FBANK(**kw)(jnp.asarray(SP)))
    got, want = _pair("IFBANK", (), kw, y, dtype)
    _close(got, want, dtype)


def test_plp_order_24_takes_the_plain_solve():
    """Order 24 over 22 frames of a CPU tensor runs the plain solve (the
    kernel's gate is a CUDA float32 batch of at least 2048), and agrees
    with the JAX package's."""
    kw = dict(plp_order=24, n_channel=40, **FB)
    before = solve.launches
    calls = []
    orig = solve.spd_solve_plain

    def spy(A, b):
        calls.append(tuple(A.shape))
        return orig(A, b)

    solve.spd_solve_plain = spy
    try:
        got = pt.PLP(**kw, **F64)(torch.as_tensor(SP))
    finally:
        solve.spd_solve_plain = orig
    assert solve.launches == before
    assert calls == [SP.shape[:-1] + (24, 24)]
    _close(got, jax.jit(dsp.PLP(**kw))(jnp.asarray(SP)))


@pytest.mark.parametrize("name,kw", [
    ("MFCC", dict(mfcc_order=12, n_channel=20, lifter=22, **FB)),
    ("PLP", dict(plp_order=24, n_channel=40, **FB))])
def test_gradient_matches_jax(name, kw):
    jop = getattr(dsp, name)(**kw)
    want = jax.jit(jax.grad(lambda s: jnp.sum(jnp.sin(jop(s)))))(
        jnp.asarray(SP))
    s = torch.as_tensor(SP).requires_grad_(True)
    torch.sum(torch.sin(getattr(pt, name)(**kw, **F64)(s))).backward()
    _close(s.grad, want)


@pytest.mark.parametrize("name,kw,path", [
    ("FBANK", dict(n_channel=20), "H"),
    ("IFBANK", dict(n_channel=20), "H"),
    ("MFCC", dict(mfcc_order=12, n_channel=20), "fbank.H"),
    ("PLP", dict(plp_order=12, n_channel=20), "fbank.H")])
def test_learnable_weights_carry_from_jax(name, kw, path):
    """learnable=True makes the filterbank weights the port's one
    parameter, under the JAX object's attribute path; JAX weights loaded
    there give the JAX output."""
    kw = dict(kw, learnable=True, **FB)
    jop = getattr(dsp, name)(**kw)
    top = getattr(pt, name)(**kw, **F64)
    assert [n for n, _ in top.named_parameters()] == [path]
    owner = jop
    for part in path.split(".")[:-1]:
        owner = getattr(owner, part)
    H = np.asarray(owner.params["H"])
    H = H * (1 + 0.1 * np.cos(np.arange(H.size).reshape(H.shape)))
    owner.params["H"] = jnp.asarray(H)
    pt.load_jax_params(top, {path: H})
    x = SP if name != "IFBANK" else np.asarray(
        dsp.FBANK(n_channel=20, **FB)(jnp.asarray(SP)))
    _close(top(torch.as_tensor(x)), jop(jnp.asarray(x)))


def test_shared_names():
    """The JAX package's 45 names of this slice are the port's too, and
    the two packages share at least 139 public names."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    shared = public(dsp) & public(pt)
    assert len(NEW_NAMES) == 45
    assert set(NEW_NAMES) <= shared
    assert len(shared) >= 139
