"""The WORLD slice of the port against the JAX package on the CPU at
float64: YIN pitch, CheapTrick, D4C, TANDEM, WorldSynthesis and
WorldVocoder.analysis_synthesis, their helpers, gradients and the carrying
of buffers.

Both sides get the same random numbers: the windowed-waveform dither and
the per-slot synthesis noise come from numpy tables (``jax.random.normal``
is patched for the JAX side, as the JAX package draws the dither from it;
``world_common.dither_noise`` and ``_slot_noise`` for the port), so these
tests hold the arithmetic apart from the random streams, which
tests/test_torch_world_noise.py holds unpatched.  Inputs
are synthetic speech made from a seed (chip_smoke.synth_speech), B=2,
T=4,000 (51 frames).

Tolerance: rtol 1e-5 / atol 1e-8 (tests/utils.py); discrete outputs (the
voicing of f0, the pulse slots) must be equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu.kernels.pallas_ola as j_ola_mod
import diffsptk_tpu_torch as pt
import diffsptk_tpu_torch.ops.world_synth as t_synth_mod
from chip_smoke import synth_speech
from diffsptk_tpu.models.world_vocoder import WorldVocoder as JWorldVocoder
from diffsptk_tpu.ops import pitch as j_pitch
from diffsptk_tpu.ops import world_common as jwc
from diffsptk_tpu.ops import world_synth as j_synth
from diffsptk_tpu_torch.ops import pitch as t_pitch
from diffsptk_tpu_torch.ops import world_common as twc
from diffsptk_tpu_torch.ops import world_synth as t_synth

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
SR, FP, FFT = 16000, 80, 1024
X = synth_speech(2, 4000).astype(np.float64)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _table(shape):
    return np.random.default_rng(3).standard_normal(tuple(shape))


NOISE = np.random.default_rng(7).standard_normal((2, 800, FFT))


def _j_noise(time_index, span, batch_offset, length, dtype):
    B, Pmax = time_index.shape
    return jnp.asarray(NOISE[:B, :Pmax, :length], dtype)


def _t_noise(time_index, span, batch_offset, length, dtype):
    B, Pmax = time_index.shape
    return torch.as_tensor(NOISE[:B, :Pmax, :length], dtype=dtype)


@pytest.fixture(scope="module", autouse=True)
def shared_noise():
    """One dither table for both sides, for this module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal",
               lambda key, shape, dtype=jnp.float64: jnp.asarray(
                   _table(shape), dtype))
    mp.setattr(twc, "dither_noise",
               lambda shape, dtype, device: torch.as_tensor(
                   _table(shape), dtype=dtype, device=device))
    yield
    mp.undo()


def _with_slots(fn):
    """``fn`` jitted, returning its result and the slot table that the
    JAX synthesis hands its overlap-add."""
    def run(*args):
        seen = {}
        orig = j_ola_mod.overlap_add

        def spy(tidx, resp, n):
            seen["tidx"] = tidx
            return orig(tidx, resp, n)

        j_ola_mod.overlap_add = spy
        try:
            out = fn(*args)
        finally:
            j_ola_mod.overlap_add = orig
        return out, seen["tidx"]

    return jax.jit(run)


def _j_synth(f0_floor=60.0):
    js = dsp.WorldSynthesis(FP, SR, FFT, f0_ceil=600.0, f0_floor=f0_floor)
    js._slot_noise = _j_noise
    return js


def _t_synth(f0_floor=60.0):
    ts = pt.WorldSynthesis(FP, SR, FFT, f0_ceil=600.0, f0_floor=f0_floor,
                           **F64)
    ts._slot_noise = _t_noise
    return ts


def _vocoders(ap_algorithm):
    jv = JWorldVocoder(ap_algorithm=ap_algorithm)
    jv.synth._slot_noise = _j_noise
    tv = pt.WorldVocoder(ap_algorithm=ap_algorithm, **F64)
    tv.synth._slot_noise = _t_noise
    return jv, tv


@pytest.fixture(scope="module")
def ref(shared_noise):
    """The JAX package's results on X, each computed once (jitted): f0,
    the CheapTrick envelope, both aperiodicities, the synthesis of the
    D4C analysis and WorldVocoder(ap_algorithm="d4c").analysis_synthesis,
    the last two with their slot tables."""
    x = jnp.asarray(X)
    f0 = jax.jit(dsp.Pitch(FP, SR, algorithm="yin", out_format="f0"))(x)
    out = {"f0": f0}
    out["sp"] = jax.jit(dsp.PitchAdaptiveSpectralAnalysis(FP, SR, FFT))(
        x, f0)
    for alg in ("d4c", "tandem"):
        out[alg] = jax.jit(dsp.Aperiodicity(FP, SR, FFT, algorithm=alg))(
            x, f0)
    synth = _with_slots(lambda *a: _j_synth()(*a, out_length=4000))
    out["synth"] = synth
    out["y"], out["slots"] = synth(f0, out["d4c"], out["sp"])
    jv, _ = _vocoders("d4c")
    out["voc"], out["voc_slots"] = _with_slots(jv.analysis_synthesis)(x)
    return {k: v if callable(v) else (np.array(v[0]), np.array(v[1]))
            if isinstance(v, tuple) else np.array(v)
            for k, v in out.items()}


@pytest.mark.parametrize("out_format", ["pitch", "f0", "log-f0", "prob"])
def test_pitch_yin(out_format):
    want = np.asarray(jax.jit(dsp.Pitch(FP, SR, algorithm="yin",
                                        out_format=out_format))(
        jnp.asarray(X)))
    got = pt.Pitch(FP, SR, algorithm="yin", out_format=out_format, **F64)(
        torch.as_tensor(X))
    assert got.shape == want.shape
    if out_format != "prob":
        unvoiced = -1e10 if out_format == "log-f0" else 0.0
        np.testing.assert_array_equal(got.numpy() == unvoiced,
                                      want == unvoiced)
        assert 0.2 < np.mean(want != unvoiced) < 1.0
    _close(got, want)
    assert not got.requires_grad


def test_yin_steps():
    frames_j = j_pitch._yin_frames(jnp.asarray(X), FP, 540, 270)
    frames_t = t_pitch._yin_frames(torch.as_tensor(X), FP, 540, 270)
    _close(frames_t, frames_j)
    d_j = j_pitch.yin_difference(frames_j, 540, 270)
    d_t = t_pitch.yin_difference(frames_t, 540, 270)
    _close(d_t, d_j, atol=1e-7)
    _close(t_pitch.yin_cmnd(d_t), j_pitch.yin_cmnd(jnp.asarray(d_t.numpy())))


def test_pitch_not_ported_and_checks():
    for algorithm in ("crepe", "fcnf0"):
        with pytest.raises(NotImplementedError):
            pt.Pitch(FP, SR, algorithm=algorithm, **F64)
    with pytest.raises(NotImplementedError):
        pt.Pitch(FP, SR, out_format="embed", **F64)(torch.as_tensor(X))
    with pytest.raises(ValueError):
        pt.Pitch(0, SR, **F64)
    with pytest.raises(ValueError):
        pt.Pitch(FP, SR, algorithm="bogus", **F64)
    with pytest.raises(ValueError):
        pt.Pitch(FP, SR, out_format="bogus", **F64)


@pytest.mark.parametrize("out_format", ["power", "db"])
def test_cheaptrick(ref, out_format):
    """The envelope; "db" against the JAX op's own formatter applied to
    the log power."""
    want = dsp.PitchAdaptiveSpectralAnalysis(
        FP, SR, FFT, out_format=out_format).formatter(jnp.log(ref["sp"]))
    got = pt.PitchAdaptiveSpectralAnalysis(FP, SR, FFT, out_format=out_format,
                                           **F64)(torch.as_tensor(X),
                                                  torch.as_tensor(ref["f0"]))
    assert got.shape == (2, ref["f0"].shape[-1], FFT // 2 + 1)
    _close(got, want)
    with pytest.raises(NotImplementedError):
        pt.PitchAdaptiveSpectralAnalysis(FP, SR, FFT, algorithm="straight",
                                         **F64)


@pytest.mark.parametrize("algorithm", ["d4c", "tandem"])
def test_aperiodicity(ref, algorithm):
    got = pt.Aperiodicity(FP, SR, FFT, algorithm=algorithm, **F64)(
        torch.as_tensor(X), torch.as_tensor(ref["f0"]))
    assert got.shape == ref[algorithm].shape
    _close(got, ref[algorithm])


def test_band_aperiodicity(ref):
    """TANDEM without interpolation (fft_length None)."""
    want = jax.jit(dsp.Aperiodicity(FP, SR, None))(jnp.asarray(X),
                                                   jnp.asarray(ref["f0"]))
    _close(pt.Aperiodicity(FP, SR, None, **F64)(
        torch.as_tensor(X), torch.as_tensor(ref["f0"])), want)


def test_aperiodicity_1d_and_formats(ref):
    """A 1-d input gives row 0 of the batch; "p/a" against the JAX op's
    own conversion."""
    want = dsp.Aperiodicity(FP, SR, FFT, out_format="p/a").convert(
        jnp.asarray(ref["tandem"][0]))
    got = pt.Aperiodicity(FP, SR, FFT, out_format="p/a", **F64)(
        torch.as_tensor(X[0]), torch.as_tensor(ref["f0"][0]))
    _close(got, want)


def test_tandem_sharded_path_raises(ref):
    ext = pt.Aperiodicity(FP, SR, FFT, **F64).extractor
    x, f = torch.as_tensor(X), torch.as_tensor(ref["f0"])
    for kw in (dict(n_offset=3), dict(band_bases=[0, 0, 0, 0]),
               dict(band_fix=lambda xb, i: xb),
               dict(carry_fix=lambda xb, i: xb)):
        with pytest.raises(NotImplementedError):
            ext(x, f, **kw)


def _t_with_slots(monkeypatch, fn, *args):
    """The port's ``fn(*args)`` and the slot table of its overlap-add."""
    seen = {}
    orig = t_synth_mod.overlap_add

    def spy(tidx, resp, n, **kwargs):
        seen["tidx"] = tidx.numpy()
        return orig(tidx, resp, n, **kwargs)

    monkeypatch.setattr(t_synth_mod, "overlap_add", spy)
    return fn(*args), seen["tidx"]


def test_world_synthesis(ref, monkeypatch):
    """The same noise table on both sides; pulse slots equal."""
    args = [torch.as_tensor(ref[k]) for k in ("f0", "d4c", "sp")]
    got, slots = _t_with_slots(
        monkeypatch, lambda *a: _t_synth()(*a, out_length=4000), *args)
    np.testing.assert_array_equal(slots, ref["slots"])
    assert got.shape == (2, 4000)
    _close(got, ref["y"])
    # a 1-d call is row 0 of the batch (row 0's noise is NOISE[0])
    _close(_t_synth()(*(a[0] for a in args), out_length=4000), ref["y"][0])


def test_world_synthesis_full_noise_length(ref):
    """f0_floor=None draws fft_length noise samples per slot."""
    args = [ref[k] for k in ("f0", "d4c", "sp")]
    want = jax.jit(lambda *a: _j_synth(None)(*a))(*args)
    _close(_t_synth(None)(*map(torch.as_tensor, args)), want)


def test_phase_fixed_point():
    rate = 2 * np.pi / SR * np.random.default_rng(4).uniform(60, 600,
                                                             (2, 9000))
    want = j_synth._wrap_phase_fixed_point(jnp.asarray(rate))
    _close(t_synth._wrap_phase_fixed_point(torch.as_tensor(rate)), want,
           rtol=0, atol=1e-12)
    want32 = j_synth._wrap_phase_fixed_point(jnp.asarray(rate, jnp.float32))
    got32 = t_synth._wrap_phase_fixed_point(torch.as_tensor(rate).float())
    np.testing.assert_array_equal(got32.numpy(), np.asarray(want32))


def test_synthesis_gradients(ref):
    """d(sum(y g)) / d(ap, sp) against jax.grad."""
    f0_, ap, sp = (ref[k] for k in ("f0", "d4c", "sp"))
    g = np.random.default_rng(5).standard_normal((2, 4000))
    js = _j_synth()

    def j_loss(a, s):
        return jnp.sum(js(jnp.asarray(f0_), a, s, out_length=4000) * g)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(ap),
                                                     jnp.asarray(sp))
    a_t = torch.as_tensor(ap).requires_grad_(True)
    s_t = torch.as_tensor(sp).requires_grad_(True)
    (_t_synth()(torch.as_tensor(f0_), a_t, s_t, out_length=4000)
     * torch.as_tensor(g)).sum().backward()
    _close(a_t.grad, want[0])
    _close(s_t.grad, want[1])


def test_world_vocoder_d4c(ref, monkeypatch):
    """configs[3]: YIN, D4C, CheapTrick, synthesis, one call each side."""
    _, tv = _vocoders("d4c")
    x = torch.as_tensor(X)
    for got, key in zip(tv.analyze(x), ("f0", "d4c", "sp")):
        _close(got, ref[key])
    got, slots = _t_with_slots(monkeypatch, tv.analysis_synthesis, x)
    np.testing.assert_array_equal(slots, ref["voc_slots"])
    assert got.shape == X.shape and torch.isfinite(got).all()
    _close(got, ref["voc"])


def test_world_vocoder_tandem(ref, monkeypatch):
    """The model's default aperiodicity: the JAX chain's synthesis of the
    TANDEM analysis."""
    want, want_slots = ref["synth"](ref["f0"], ref["tandem"], ref["sp"])
    _, tv = _vocoders("tandem")
    got, slots = _t_with_slots(monkeypatch, tv.analysis_synthesis,
                               torch.as_tensor(X))
    np.testing.assert_array_equal(slots, np.asarray(want_slots))
    _close(got, want)


def test_world_vocoder_even_frames():
    jv, tv = _vocoders("tandem")
    want = jax.jit(lambda v: jv.analyze(v, even_frames=True))(jnp.asarray(X))
    got = tv.analyze(torch.as_tensor(X), even_frames=True)
    assert got[0].shape == (2, 4000 // FP)
    for g, w in zip(got, want):
        _close(g, w)


def test_world_vocoder_gradient_wrt_x():
    """d(sum(y g)) / dx through analysis (f0 detached) and synthesis."""
    x = X[:1, :2400]
    g = np.random.default_rng(6).standard_normal(x.shape)
    jv, tv = _vocoders("d4c")
    want = jax.jit(jax.grad(
        lambda v: jnp.sum(jv.analysis_synthesis(v) * g)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (tv.analysis_synthesis(xt) * torch.as_tensor(g)).sum().backward()
    assert xt.grad.abs().max() > 0
    _close(xt.grad, want)


def test_load_jax_params_world_vocoder(ref):
    """A perturbed TANDEM regularizer carries across as ap.extractor.eye."""
    eye = np.diag(np.random.default_rng(8).uniform(1e-3, 2e-3, 6))
    jv, tv = _vocoders("tandem")
    jv.ap.extractor.eye = jnp.asarray(eye)
    pt.load_jax_params(tv, {"ap.extractor.eye": eye})
    _close(tv.ap.extractor.eye, eye)
    x, f0 = jnp.asarray(X), jnp.asarray(ref["f0"])
    want = jax.jit(jv.ap)(x, f0)
    assert np.abs(np.asarray(want) - ref["tandem"]).max() > 1e-6
    _close(tv.ap(torch.as_tensor(X), torch.as_tensor(ref["f0"])), want)
    names = dict(tv.named_buffers())
    for name in ("ap.extractor.hHP", "ap.extractor.window",
                 "spec.extractor.ramp", "synth.ramp"):
        assert name in names
def test_world_common_helpers():
    rng = np.random.default_rng(9)
    xs = np.sort(rng.uniform(0, 10, 12))
    ys = rng.standard_normal((3, 12))
    xq = rng.uniform(-1, 11, (3, 20))
    for method in ("linear", "*linear"):
        _close(twc.interp1(torch.as_tensor(xs), torch.as_tensor(ys),
                           torch.as_tensor(xq), method=method),
               jwc.interp1(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xq),
                           method=method, batching=(False, True)))
    with pytest.raises(ValueError):
        twc.interp1(torch.as_tensor(xs), torch.as_tensor(ys[0]),
                    torch.as_tensor(xq[0]), method="cubic")
    xi = rng.uniform(0, 11, (3, 20))
    _close(twc.interp1Q(0.5, 0.75, torch.as_tensor(ys), torch.as_tensor(xi)),
           jwc.interp1Q(0.5, 0.75, jnp.asarray(ys), jnp.asarray(xi)))
    spec = np.exp(rng.standard_normal((2, 3, 65)))
    want = jwc.get_minimum_phase_spectrum(jnp.asarray(spec))
    _close(twc.get_minimum_phase_spectrum(torch.as_tensor(spec)).numpy(),
           np.asarray(want))
    for n_frames in (51, 50):
        _close(twc.frames_matching_f0(torch.as_tensor(X), n_frames, 1024, FP,
                                      zmean=True),
               jwc.frames_matching_f0(jnp.asarray(X), n_frames, 1024, FP,
                                      zmean=True))
    for got, want in zip(twc.synthesis_response_plans(64),
                         jwc.synthesis_response_plans(64)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(twc.noise_dft_plans(48, 64),
                         jwc.noise_dft_plans(48, 64)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        twc.minimum_phase_plans(63)


def test_dc_correction_and_smoothing():
    rng = np.random.default_rng(10)
    ps = np.exp(rng.standard_normal((2, 7, FFT // 2 + 1)))
    f0 = rng.uniform(60, 600, (2, 7, 1))
    ramp = np.arange(FFT, dtype=np.float64)
    args = (ps, f0)
    t_args = [torch.as_tensor(a) for a in args]
    for max_bins in (None, 80):
        want = jax.jit(lambda p, f: jwc.dc_correction(
            p, f, SR, FFT, jnp.asarray(ramp), max_bins))(*args)
        _close(twc.dc_correction(*t_args, SR, FFT, torch.as_tensor(ramp),
                                 max_bins), want)
    want = jax.jit(lambda p, f: jwc.linear_smoothing(
        p, f, SR, FFT, jnp.asarray(ramp), 80))(*args)
    _close(twc.linear_smoothing(*t_args, SR, FFT, torch.as_tensor(ramp), 80),
           want)


def test_d4c_float32_close_to_float64(ref):
    """The float32 smoothing keeps its running sum as a float64-exact
    pair, so float32 D4C stays within 1e-4 of float64 on every bin (a
    float32 running sum moves it by up to 0.8 on this speech)."""
    x, f0 = torch.as_tensor(X), torch.as_tensor(ref["f0"])
    ap64 = pt.Aperiodicity(FP, SR, FFT, algorithm="d4c", **F64)(x, f0)
    ap32 = pt.Aperiodicity(FP, SR, FFT, algorithm="d4c", device="cpu",
                           dtype=torch.float32)(x.float(), f0.float())
    assert float((ap32.double() - ap64).abs().max()) < 1e-4


def test_linear_smoothing_float32_close_to_float64():
    """The port's float32 smoothing, on a spectrum that falls 100 dB
    across its bins, stays within 1e-4 of float64 relative to every bin.
    This departs on purpose from the JAX package's float32 path, whose
    float32 running sum is off by a factor of about 30 in the lowest
    bins of this spectrum."""
    rng = np.random.default_rng(11)
    k = np.arange(FFT // 2 + 1)
    ps = 10 ** (-10 * k / k[-1]) * np.exp(rng.standard_normal((2, 7, k.size)))
    width = rng.uniform(60, 600, (2, 7, 1))
    ramp = np.arange(FFT, dtype=np.float64)
    args = [torch.as_tensor(a) for a in (ps, width, ramp)]
    want = twc.linear_smoothing(args[0], args[1], SR, FFT, args[2], 80)
    got = twc.linear_smoothing(args[0].float(), args[1].float(), SR, FFT,
                               args[2].float(), 80)
    assert got.dtype == torch.float32
    rel = ((got.double() - want).abs() / want.abs()).max()
    assert float(rel) < 1e-4, float(rel)
