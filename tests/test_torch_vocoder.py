"""The whole slice: MelCepstralVocoder of the port against the JAX chain
(float64 on the CPU, B=2, T=3,200), and carrying JAX parameters across.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu.models.mcep_vocoder import MelCepstralVocoder as JVocoder
from diffsptk_tpu.ops.mglsadf import PseudoMGLSADigitalFilter as JMLSA

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)
X = np.random.default_rng(11).standard_normal((2, 3200))


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX chain's mc and round trip.  Off the TPU its fused cascade
    is the folded form, so one run serves both port cascades."""
    voc = JVocoder(cascade="folded")
    x = jnp.asarray(X)
    return (np.asarray(jax.jit(voc.analyze)(x)),
            np.asarray(jax.jit(voc.analysis_synthesis)(x)))


@pytest.mark.parametrize("cascade", ["folded", "fused"])
def test_analysis_synthesis_matches_jax(jax_chain, cascade):
    mc_want, y_want = jax_chain
    voc = pt.MelCepstralVocoder(cascade=cascade, **F64)
    x = torch.as_tensor(X)
    np.testing.assert_allclose(voc.analyze(x).numpy(), mc_want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(voc.analysis_synthesis(x).numpy(), y_want,
                               rtol=RTOL, atol=ATOL)


def test_chain_gradient_is_finite():
    voc = pt.MelCepstralVocoder(cascade="fused", **F64)
    x = torch.as_tensor(X[:1, :1600]).requires_grad_(True)
    (voc.analysis_synthesis(x) ** 2).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


SMALL = dict(frame_length=64, frame_period=16, fft_length=64, cep_order=6,
             n_iter=2, taylor_order=4, cep_order_mlsa=39)


def test_load_jax_params_vocoder():
    """Perturbed Taylor weights of both filters carry across."""
    rng = np.random.default_rng(12)
    a1 = 1.0 + 0.1 * rng.standard_normal(5)
    a2 = 1.0 + 0.1 * rng.standard_normal(5)
    jv = JVocoder(**SMALL)
    jv.mlsa.mglsadf.a = jnp.asarray(a1)
    jv.imlsa.mglsadf.mglsadf.a = jnp.asarray(a2)
    x = X[:, :640]
    want = np.asarray(jv.analysis_synthesis(jnp.asarray(x)))

    tv = pt.MelCepstralVocoder(**SMALL, **F64)
    pt.load_jax_params(tv, {"mlsa.mglsadf.a": a1,
                            "imlsa.mglsadf.mglsadf.a": a2})
    got = tv.analysis_synthesis(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_jax_params_learnable_filter():
    rng = np.random.default_rng(13)
    a = 1.0 + 0.1 * rng.standard_normal(5)
    jf = JMLSA(6, 16, alpha=0.42, taylor_order=4, cep_order=39,
               learnable=True)
    jf.mglsadf.a = jnp.asarray(a)
    x = rng.standard_normal((2, 64))
    mc = rng.standard_normal((2, 4, 7)) * 0.1
    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(mc)))

    tf = pt.MLSA(6, 16, alpha=0.42, taylor_order=4, cep_order=39,
                 learnable=True, **F64)
    assert [n for n, _ in tf.named_parameters()] == ["mglsadf.a"]
    with pytest.raises(KeyError):
        pt.load_jax_params(tf, {})                          # missing
    with pytest.raises(KeyError):
        pt.load_jax_params(tf, {"mglsadf.a": a, "mglsadf.b": a})  # extra
    with pytest.raises(ValueError):
        pt.load_jax_params(tf, {"mglsadf.a": a[:3]})        # shape
    pt.load_jax_params(tf, {"mglsadf.a": a})
    got = tf(torch.as_tensor(x), torch.as_tensor(mc))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    got.sum().backward()
    assert tf.mglsadf.a.grad is not None
