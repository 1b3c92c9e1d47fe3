"""WORLD as BASELINE.json configs[3] names it, FCNF0 -> D4C -> CheapTrick ->
synthesis: the port against the JAX package on the CPU at float64, both
drawing their own noise (JAX's threefry streams), unpatched.

FCNF0 runs in float32 in both packages.  Its f0, the aperiodicity and the
envelope are held at rtol 1e-5 / atol 1e-8, voicing equal; the synthesis
of the JAX package's own analysis too.  The whole analysis-synthesis is
held at the float32 networks' tolerance, rtol 1e-4 / atol 1e-6: the
synthesis places its pulses by the running phase of f0, so the float32
networks' last-bit differences in f0 (about 1e-8 relative) move y by up
to 1e-6.  The JAX reference is computed once (jitted)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu.models.world_vocoder import WorldVocoder as JWorldVocoder

RTOL, ATOL = 1e-5, 1e-8
NN_RTOL, NN_ATOL = 1e-4, 1e-6
F64 = dict(device="cpu", dtype=torch.float64)
KW = dict(pitch_algorithm="fcnf0", ap_algorithm="d4c")
B, T = 2, 4000


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def ref():
    jv = JWorldVocoder(**KW)
    x = jnp.asarray(synth_speech(B, T).astype(np.float64))
    analysis = jax.jit(jv.analyze)(x)
    y = jax.jit(jv.synthesize, static_argnames="out_length")(
        *analysis, out_length=T)
    return [np.asarray(a) for a in analysis], np.asarray(y)


@pytest.fixture(scope="module")
def voc():
    return pt.WorldVocoder(**KW, **F64)


def test_analysis_matches_jax(ref, voc):
    x = torch.as_tensor(synth_speech(B, T).astype(np.float64))
    f0, ap, sp = voc.analyze(x)
    want_f0, want_ap, want_sp = ref[0]
    np.testing.assert_array_equal(f0.numpy() > 0, want_f0 > 0)
    assert (want_f0 > 0).mean() > 0.5
    for got, want in ((f0, want_f0), (ap, want_ap), (sp, want_sp)):
        assert got.shape == want.shape
        _close(got, want)


def test_synthesis_of_the_jax_analysis_matches_jax(ref, voc):
    y = voc.synthesize(*(torch.tensor(a) for a in ref[0]), out_length=T)
    _close(y, ref[1])


def test_analysis_synthesis_matches_jax(ref, voc):
    y = voc.analysis_synthesis(torch.as_tensor(
        synth_speech(B, T).astype(np.float64)))
    assert y.shape == (B, T)
    _close(y, ref[1], NN_RTOL, NN_ATOL)
