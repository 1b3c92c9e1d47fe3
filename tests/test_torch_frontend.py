"""Port front end (frame, window, fftr, spec, STFT) against the JAX
package on the same numpy inputs, float64 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu.ops.fftr import RealValuedFastFourierTransform as JFftr
from diffsptk_tpu.ops.frame import Frame as JFrame
from diffsptk_tpu.ops.spec import Spectrum as JSpectrum
from diffsptk_tpu.ops.stft import ShortTimeFourierTransform as JSTFT
from diffsptk_tpu.ops.window import Window as JWindow

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("center,zmean,mode", [
    (True, False, "constant"), (False, False, "constant"),
    (True, True, "reflect"), (True, False, "replicate"),
    (False, False, "circular")])
def test_frame(center, zmean, mode):
    x = _rng(0).standard_normal((2, 3, 101))
    kw = dict(center=center, zmean=zmean, mode=mode)
    want = JFrame(16, 5, **kw)(jnp.asarray(x))
    got = pt.Frame(16, 5, **kw, **F64)(torch.as_tensor(x))
    _close(got, want)


@pytest.mark.parametrize("window", ["blackman", "hamming", "hanning",
                                    "bartlett", "trapezoidal",
                                    "rectangular", "nuttall", "povey",
                                    "sine", "vorbis", "kbd"])
@pytest.mark.parametrize("norm", ["none", "power", "magnitude"])
def test_window(window, norm):
    x = _rng(1).standard_normal((3, 20))
    want = JWindow(20, 32, window=window, norm=norm)(jnp.asarray(x))
    got = pt.Window(20, 32, window=window, norm=norm, **F64)(
        torch.as_tensor(x))
    _close(got, want)


@pytest.mark.parametrize("out_format", ["complex", "real", "imaginary",
                                        "amplitude", "power"])
@pytest.mark.parametrize("learnable", [False, True])
def test_fftr(out_format, learnable):
    x = _rng(2).standard_normal((4, 12))
    want = JFftr(16, out_format, learnable=learnable)(jnp.asarray(x))
    op = pt.RealValuedFastFourierTransform(16, out_format,
                                           learnable=learnable, **F64)
    got = op(torch.as_tensor(x))
    _close(got, want)
    assert ("W" in dict(op.named_parameters())) == learnable


@pytest.mark.parametrize("which", ["b", "a", "ab"])
def test_spectrum(which):
    rng = _rng(3)
    b = rng.standard_normal((3, 9))
    a = np.concatenate([np.ones((3, 1)), 0.2 * rng.standard_normal((3, 6))],
                       axis=-1)
    kw = dict(eps=1e-6, relative_floor=-40.0, out_format="db")
    args = dict(b=b if "b" in which else None,
                a=a if "a" in which else None)
    want = JSpectrum(32, **kw)(
        *[None if v is None else jnp.asarray(v) for v in args.values()])
    got = pt.Spectrum(32, **kw, **F64)(
        *[None if v is None else torch.as_tensor(v) for v in args.values()])
    _close(got, want)


@pytest.mark.parametrize("out_format", ["power", "complex"])
def test_stft_flagship_geometry(out_format):
    """STFT(400, 80, 512, eps=0, relative_floor=-80) as the vocoder
    builds it."""
    x = _rng(4).standard_normal((2, 3200))
    kw = dict(eps=0, relative_floor=-80, out_format=out_format)
    want = JSTFT(400, 80, 512, **kw)(jnp.asarray(x))
    got = pt.STFT(400, 80, 512, **kw, **F64)(torch.as_tensor(x))
    _close(got, want)


def test_stft_learnable_parameters():
    op = pt.STFT(16, 4, 16, learnable=True, **F64)
    names = sorted(n for n, _ in op.named_parameters())
    assert names == ["spec.fftr.W", "window.window"]
    with pytest.raises(ValueError):
        pt.STFT(16, 4, 16, learnable=["phase"], **F64)
