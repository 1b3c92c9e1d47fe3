"""The port's neural pitch trackers (CREPE, FCNF0++) against the JAX package
on the CPU.

The networks run in float32 in both packages (the weights stay float32
under a float64 module), so their outputs are held at the float32
tolerance, rtol 1e-4 / atol 1e-6; what follows them (decoding, filters,
loudness) at float64 is held at rtol 1e-5 / atol 1e-8, and discrete
outputs (voicing, decoded bins, Viterbi paths) must be equal.

CREPE's embeddings and FCNF0's logits are unbounded activations (up to
about 3 and 5 in size), where float32 accumulation leaves each package a
few 1e-6 from a float64 evaluation of the same network (CREPE-tiny
embeddings: JAX 2.0e-6, the port 4.2e-6; FCNF0 logits at the random
init: 6.8e-6 and 7.7e-6).  So the forwards are held twice: at float64,
where the two packages compute the same function, at rtol 1e-5 / atol
1e-8; and at float32 at rtol 1e-4 with an atol of 1e-5 of the output's
largest magnitude.  The random
inits are the JAX package's draws, carried into the port with
``load_jax_params``; the bundled checkpoints are read from
``diffsptk_tpu/assets``.  Inputs: a harmonic tone and 0.3-sigma noise of
0.5 s from a seed, and ``chip_smoke.synth_speech``.  Each JAX reference is
computed once."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu.ops import pitch_nn as jnn
from diffsptk_tpu_torch.ops import pitch_nn as tnn
from diffsptk_tpu_torch.utils.carry import load_jax_params

RTOL, ATOL = 1e-5, 1e-8
NN_RTOL, NN_ATOL = 1e-4, 1e-6
F64 = dict(device="cpu", dtype=torch.float64)
SR, FP, T = 16000, 80, 8000
FORMATS = ("pitch", "f0", "log-f0", "prob")
# FCNF0 as the WORLD chain builds it (f_min/f_max pass through); CREPE tiny
ALGOS = {"fcnf0": dict(f_min=60.0, f_max=500.0),
         "crepe": dict(model="tiny")}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _close_activations(got, want):
    """float32 activations: rtol 1e-4, atol 1e-5 of max|want|."""
    _close(got, want, NN_RTOL, 1e-5 * float(np.abs(np.asarray(want)).max()))


def _signals() -> np.ndarray:
    """Row 0: a 180 Hz tone with two harmonics; row 1: 0.3-sigma noise;
    row 2: synthetic speech (a gliding f0 through three formants)."""
    t = np.arange(T) / SR
    tone = (0.5 * np.sin(2 * np.pi * 180 * t)
            + 0.3 * np.sin(2 * np.pi * 360 * t + 0.4)
            + 0.1 * np.sin(2 * np.pi * 540 * t + 1.1))
    noise = 0.3 * np.random.default_rng(8).standard_normal(T)
    return np.stack([tone, noise, synth_speech(1, T)[0].astype(np.float64)])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's Pitch in every format (and CREPE's embeddings)."""
    x = jnp.asarray(_signals())
    out = {}
    for algo, kw in ALGOS.items():
        fmts = FORMATS + (("embed",) if algo == "crepe" else ())
        ops = [dsp.Pitch(FP, SR, algorithm=algo, out_format=f, **kw)
               for f in fmts]
        res = jax.jit(lambda x, ops=ops: [op(x) for op in ops])(x)
        for f, r in zip(fmts, res):
            out[algo, f] = np.asarray(r)
    return out


@pytest.mark.parametrize("fmt", FORMATS + ("embed",))
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_pitch_matches_jax(ref, algo, fmt):
    op = pt.Pitch(FP, SR, algorithm=algo, out_format=fmt, **ALGOS[algo],
                  **F64)
    x = torch.as_tensor(_signals())
    if algo == "fcnf0" and fmt == "embed":
        with pytest.raises(NotImplementedError):
            op(x)
        return
    got = op(x)
    want = ref[algo, fmt]
    assert got.shape == want.shape and got.dtype == torch.float64
    if fmt == "prob":
        _close(got, want, NN_RTOL, NN_ATOL)
        return
    if fmt == "embed":
        _close_activations(got, want)
        return
    unvoiced = {"pitch": 0.0, "f0": 0.0, "log-f0": -1e10}[fmt]
    np.testing.assert_array_equal(got.numpy() == unvoiced, want == unvoiced)
    assert (want != unvoiced).any() and (want == unvoiced).any()
    _close(got, want)


def test_yin_and_neural_trackers_agree_on_the_frame_count(ref):
    f0 = pt.Pitch(FP, SR, algorithm="yin", out_format="f0", **F64)(
        torch.as_tensor(_signals()))
    assert f0.shape == ref["fcnf0", "f0"].shape == ref["crepe", "f0"].shape


def test_pitch_without_a_card():
    if torch.cuda.is_available():
        op = pt.Pitch(FP, SR, algorithm="crepe", model="tiny")
        assert op.extractor.transition.device.type == "cuda"
        return
    for algo in ("fcnf0", "crepe", "yin"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Pitch(FP, SR, algorithm=algo, out_format="f0")


def test_world_vocoder_keeps_float32_network_weights(ref):
    voc = pt.WorldVocoder(pitch_algorithm="fcnf0", **F64)
    ext = voc.pitch.extractor
    for name, buf in ext.named_buffers():
        want = (torch.float32 if name in ext.params else torch.float64)
        assert buf.dtype == want, name
    assert set(ext.params) == set(jnn.init_fcnf0_params())
    voc.to(torch.float64)
    assert ext.params["block0.conv.weight"].dtype == torch.float32
    f0 = voc.pitch(torch.as_tensor(_signals()))
    want = ref["fcnf0", "f0"]
    np.testing.assert_array_equal(f0.numpy() > 0, want > 0)
    _close(f0, want)


def test_bundled_weights_are_the_jax_package_checkpoints():
    for algo, kw in ALGOS.items():
        j = dsp.Pitch(FP, SR, algorithm=algo, **kw).extractor.params
        t = pt.Pitch(FP, SR, algorithm=algo, **kw, **F64).extractor.params
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("mode,zmean", [("constant", True),
                                        ("reflect", False)])
@pytest.mark.parametrize("T_", [1500, 1600])
def test_hop_frames_matches_jax(mode, zmean, T_):
    x = np.random.default_rng(T_).standard_normal((2, T_))
    want = jnn.hop_frames(jnp.asarray(x), 1024, 40, mode=mode, zmean=zmean)
    got = tnn.hop_frames(torch.as_tensor(x), 1024, 40, mode=mode,
                         zmean=zmean)
    assert got.shape == want.shape == (2, T_ // 40 + 1, 1024)
    _close(got, want)


def _frames(n: int) -> np.ndarray:
    f = np.random.default_rng(n).standard_normal((n, 1024))
    return (f / f.std(-1, keepdims=True)).astype(np.float32)


# jitted with the weights as arguments: one compile, not one per op
_jax_crepe = jax.jit(jnn.crepe_forward, static_argnums=(2, 3))
_jax_fcnf0 = jax.jit(jnn.fcnf0_forward)


@pytest.mark.parametrize("model", ["tiny", "full"])
def test_crepe_forward_with_the_jax_init(model):
    params = jnn.init_crepe_params(model)
    for k, v in tnn.init_crepe_params(model).items():
        np.testing.assert_array_equal(v, params[k])
    ext = tnn.PitchExtractionByCREPE(FP, SR, model=model, weights=params,
                                     **F64)
    load_jax_params(ext, params)
    frames = _frames(3 if model == "tiny" else 1)
    p64 = {k: v.double() for k, v in ext.params.items()}
    params64 = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    for embed in (False, True):
        want = _jax_crepe(params, jnp.asarray(frames), model, embed)
        got = tnn.crepe_forward(ext.params, torch.as_tensor(frames), model,
                                embed=embed)
        assert got.dtype == torch.float32 and got.shape == want.shape
        if embed:
            _close_activations(got, want)
        else:
            _close(got, want, NN_RTOL, NN_ATOL)
        if model == "full":       # the same code as "tiny" at float64
            continue
        want64 = _jax_crepe(params64, jnp.asarray(frames, jnp.float64),
                            model, embed)
        _close(tnn.crepe_forward(p64, torch.as_tensor(frames).double(),
                                 model, embed=embed), want64)


def test_fcnf0_forward_with_the_jax_init():
    params = jnn.init_fcnf0_params()
    for k, v in tnn.init_fcnf0_params().items():
        np.testing.assert_array_equal(v, params[k])
    ext = tnn.PitchExtractionByFCNF0(FP, SR, **F64)
    load_jax_params(ext, params)
    frames = _frames(2)
    want = _jax_fcnf0(params, jnp.asarray(frames))
    got = tnn.fcnf0_forward(ext.params, torch.as_tensor(frames))
    assert got.shape == want.shape == (2, tnn.PENN_PITCH_BINS)
    _close_activations(got, want)
    want64 = _jax_fcnf0({k: jnp.asarray(v, jnp.float64)
                         for k, v in params.items()},
                        jnp.asarray(frames, jnp.float64))
    p64 = {k: v.double() for k, v in ext.params.items()}
    _close(tnn.fcnf0_forward(p64, torch.as_tensor(frames).double()), want64)


def test_viterbi_matches_jax_on_random_probabilities():
    rng = np.random.default_rng(11)
    probs = rng.uniform(size=(2, 3, 30, tnn.CREPE_PITCH_BINS))
    trans = tnn.crepe_transition()
    np.testing.assert_array_equal(trans, jnn.crepe_transition())
    want = np.asarray(jnn.viterbi_decode(jnp.asarray(probs),
                                         jnp.asarray(trans)))
    got = tnn.viterbi_decode(torch.as_tensor(probs), torch.as_tensor(trans))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_viterbi_breaks_a_tie_as_jax():
    """Two equal peaks, far from the edges, in every frame: the path's
    final state is an exact tie, which both take at the first index."""
    probs = np.full((12, tnn.CREPE_PITCH_BINS), 1e-3)
    probs[:, 100] = probs[:, 200] = 0.9
    trans = tnn.crepe_transition()
    want = np.asarray(jnn.viterbi_decode(jnp.asarray(probs),
                                         jnp.asarray(trans)))
    got = tnn.viterbi_decode(torch.as_tensor(probs), torch.as_tensor(trans))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 100).all()


def test_weighted_cents_matches_jax():
    rng = np.random.default_rng(12)
    probs = rng.uniform(size=(2, 9, tnn.PENN_PITCH_BINS))
    bins = rng.integers(0, tnn.PENN_PITCH_BINS, size=(2, 9))
    bins[0, :2] = (0, tnn.PENN_PITCH_BINS - 1)         # clipped windows
    for window, fn in ((4, "crepe"), (19, "penn")):
        jf = (jnn.crepe_bins_to_cents if fn == "crepe"
              else (lambda b: tnn.PENN_CENTS_PER_BIN * b))
        tf = (tnn.crepe_bins_to_cents if fn == "crepe"
              else (lambda b: tnn.PENN_CENTS_PER_BIN * b))
        want = jnn.weighted_cents(jnp.asarray(probs), jnp.asarray(bins), jf,
                                  window=window)
        got = tnn.weighted_cents(torch.as_tensor(probs),
                                 torch.as_tensor(bins), tf, window=window)
        _close(got, want)


@pytest.mark.parametrize("width", [1, 3, 4, 5])
def test_filters_match_jax(width):
    x = np.random.default_rng(width).standard_normal((2, 17))
    for jf, tf in ((jnn.median_filter, tnn.median_filter),
                   (jnn.mean_filter, tnn.mean_filter)):
        _close(tf(torch.as_tensor(x), width), jf(jnp.asarray(x), width))


def test_load_params_errors(tmp_path):
    shapes = tnn.fcnf0_shapes()
    params = tnn.init_fcnf0_params()
    partial = {k: v for k, v in params.items() if k != "head.bias"}
    with pytest.raises(ValueError, match="missing parameters.*head.bias"):
        tnn.load_params(partial, tnn.init_fcnf0_params, expect=shapes)
    bad = dict(params, **{"head.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch for head.bias"):
        tnn.load_params(bad, tnn.init_fcnf0_params, expect=shapes)
    with pytest.raises(FileNotFoundError, match="not_there.npz"):
        tnn.load_params(None, tnn.init_fcnf0_params, expect=shapes,
                        bundled="not_there.npz")
    path = tmp_path / "w.npz"
    np.savez(path, **params)
    loaded = tnn.load_params(str(path), tnn.init_fcnf0_params,
                             expect=shapes)
    ckpt = tmp_path / "w.pt"
    torch.save({"state_dict": {k: torch.as_tensor(v)
                               for k, v in params.items()}}, ckpt)
    from_torch = tnn.load_params(str(ckpt), tnn.init_fcnf0_params,
                                 expect=shapes)
    for k in shapes:
        np.testing.assert_array_equal(loaded[k], params[k])
        np.testing.assert_array_equal(from_torch[k], params[k])
    ext = tnn.PitchExtractionByCREPE(FP, SR, model="tiny", **F64)
    with pytest.raises(KeyError):
        load_jax_params(ext, {"conv9.weight": np.zeros(3)})


def test_network_precision_is_scoped():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with tnn.network_precision("tf32"):
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    with tnn.network_precision("full"):
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    # TF32 where its f0 stays within a third of a cent of full fp32 on the
    # card (FCNF0); full fp32 where TF32 moved CREPE's Viterbi path
    defaults = {algo: pt.Pitch(FP, SR, algorithm=algo, **kw, **F64)
                .extractor.PRECISION for algo, kw in ALGOS.items()}
    assert defaults == {"fcnf0": "tf32", "crepe": "full"}
