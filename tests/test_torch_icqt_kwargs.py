"""The inverse constant-Q transform takes the keywords the JAX class
takes: extra ones (the forward transform's resampler options, such as
``rolloff``) are accepted and ignored in both packages, directly and
through the sharded class.  Held to the JAX package on the same float64
CQT from a seed at rtol 1e-5 / atol 1e-8 (tests/utils.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.parallel.filterbanks import ShardedICQT

KW = dict(n_bin=24, rolloff=0.9)
T = 1280


def _cqt() -> np.ndarray:
    """A float64 CQT (2, frames, 24) from a seed: the JAX forward
    transform of seeded noise, so that the inverse sees real spectra."""
    x = np.random.default_rng(23).standard_normal((2, T))
    return np.array(dsp.CQT(80, 16000, n_bin=24, dtype=jnp.float64)(
        jnp.asarray(x)))


def test_icqt_accepts_and_ignores_extra_keywords():
    c = _cqt()
    want = np.asarray(dsp.ICQT(80, 16000, **KW, dtype=jnp.float64)(
        jnp.asarray(c), out_length=T))
    op = pt.ICQT(80, 16000, **KW, dtype=torch.float64, device="cpu")
    got = op(torch.as_tensor(c), out_length=T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)
    plain = pt.ICQT(80, 16000, n_bin=24, dtype=torch.float64, device="cpu")
    assert torch.equal(plain(torch.as_tensor(c), out_length=T), got)


def test_sharded_icqt_forwards_extra_keywords():
    """The sharded class builds its local operator with the same keywords
    (its constructor only keeps the mesh, so none is needed here), at
    bench_all.py's frame period, which the sharded class takes."""
    op = ShardedICQT(None, 64, 16000, **KW, dtype=torch.float64,
                     device="cpu")
    plain = pt.ICQT(64, 16000, n_bin=24, dtype=torch.float64, device="cpu")
    assert isinstance(op.op, pt.ICQT)
    for name, basis in plain.named_buffers():
        assert torch.equal(dict(op.op.named_buffers())[name], basis)
