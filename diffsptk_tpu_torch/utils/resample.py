"""Polyphase sinc resampling, kaiser-windowed (counterpart of
``diffsptk_tpu/utils/resample.py``).

The kernel bank is designed on the host in numpy float64; it is applied
in full fp32 (the JAX package runs it at ``Precision.HIGHEST``) by one of
three paths: an integer downsample as one FIR per input phase, an integer
upsample as one FIR bank whose phases interleave, and any other ratio as
a framed matmul.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import full_precision, place
from ..kernels.fir import fir_correlate

_KAISER_BEST = dict(lowpass_filter_width=64, rolloff=0.9475937167399596,
                    beta=14.769656459379492)
_KAISER_FAST = dict(lowpass_filter_width=16, rolloff=0.85,
                    beta=8.555504641634386)


def get_resample_params(mode: str = "kaiser_best") -> dict:
    if mode == "kaiser_best":
        return dict(_KAISER_BEST)
    if mode == "kaiser_fast":
        return dict(_KAISER_FAST)
    raise ValueError("Only kaiser_best and kaiser_fast are supported.")


def design_resample_kernel(orig_freq: int, new_freq: int,
                           lowpass_filter_width: int = 64,
                           rolloff: float = 0.9475937167399596,
                           beta: float | None = 14.769656459379492):
    """Kaiser-windowed sinc kernel bank (new_freq, 1, K) and the left pad
    width, following the standard polyphase construction."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig_freq = int(orig_freq) // g
    new_freq = int(new_freq) // g

    base_freq = min(orig_freq, new_freq) * rolloff
    width = int(math.ceil(lowpass_filter_width * orig_freq / base_freq))
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] \
        / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx) \
        * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    if beta is None:
        beta = 14.769656459379492
    window = np.i0(beta * np.sqrt(np.maximum(
        1 - (t / lowpass_filter_width) ** 2, 0.0))) / np.i0(beta)
    t = t * np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel[:, None, :], width, orig_freq, new_freq


class Resampler(nn.Module):
    """Rate conversion by new_freq/orig_freq with kaiser-windowed sinc:
    (..., T) -> (..., ceil(T * new_freq / orig_freq))."""

    def __init__(self, orig_freq: int, new_freq: int, *,
                 lowpass_filter_width: int = 64,
                 rolloff: float = 0.9475937167399596,
                 beta: float | None = 14.769656459379492,
                 resampling_method: str = "sinc_interp_kaiser",
                 dtype=None, device=None) -> None:
        super().__init__()
        kernel, width, orig, new = design_resample_kernel(
            orig_freq, new_freq, lowpass_filter_width, rolloff, beta)
        self.width = width
        self.orig_freq = orig
        self.new_freq = new
        kern = kernel[:, 0, :]                              # (P, K)
        K = kern.shape[-1]
        if new == 1 and orig > 1:
            # one FIR per input phase, as the D input channels of one conv
            D = orig
            taps = -(-K // D)
            bank = np.zeros((1, D, taps))
            for p in range(D):
                hp = kern[0, p::D]
                bank[0, p, :hp.shape[-1]] = hp
            kern = bank
        self.register_buffer("kernel", torch.as_tensor(kern))
        self.taps = K
        place(self, device, dtype)

    @full_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.orig_freq == self.new_freq:
            return x
        shape = x.shape
        T = shape[-1]
        xf = x.reshape(-1, T)
        target_length = -(-self.new_freq * T // self.orig_freq)   # ceil
        xf = F.pad(xf, (self.width, self.width + self.orig_freq))
        K = self.taps
        n_frames = (xf.shape[-1] - K) // self.orig_freq + 1
        kern = self.kernel.to(x.dtype)
        if self.new_freq == 1 and self.orig_freq > 1:
            # Integer downsample by D: the D input phases of x as the
            # channels of one conv, each with its own FIR.
            D = self.orig_freq
            L = (n_frames + -(-K // D)) * D
            xz = F.pad(xf, (0, max(0, L - xf.shape[-1])))[..., :L]
            xp = xz.reshape(xf.shape[0], -1, D).transpose(1, 2)   # (B, D, L/D)
            y = F.conv1d(xp, kern)[:, 0, :n_frames]
        elif self.orig_freq == 1 and self.new_freq > 1:
            # Integer upsample by P: one FIR bank with P output phases,
            # interleaved.
            ph = fir_correlate(xf, kern)                         # (B, P, n)
            y = ph.transpose(-2, -1).reshape(xf.shape[0], -1)
        else:
            # Rational ratio: frame n covers [n*orig, n*orig + K); all
            # phases from one (n, K) @ (K, P) matmul.
            frames = xf.unfold(-1, K, self.orig_freq)[:, :n_frames]
            y = (frames @ kern.T).reshape(xf.shape[0], -1)
        y = y[..., :target_length]
        return y.reshape(*shape[:-1], target_length)
