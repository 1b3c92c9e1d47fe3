"""Constant-Q transform and its inverse (counterpart of
``diffsptk_tpu/ops/cqt.py``).

Recursive-downsample VQT: per octave, a rectangular-window STFT and one
complex matmul against the octave's FFT-domain basis, with a halving
resampler between octaves.  Every octave shares one FFT length, as in the
JAX package.  The inverse folds each octave's inverse FFT into rank-2K
time bases against [Re C | Im C], as the JAX package does; the frames
they give (each as long as the shared FFT, 8,192 samples at 16 kHz and 24
bins) are overlap-added as they are made, by one transposed convolution
per octave, so no frame is held in memory.  Then each octave is
upsampled.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import child, full_precision, place
from ..utils.resample import Resampler, get_resample_params
from .cqt_design import (
    cqt_frequencies,
    early_downsample_count,
    et_relative_bw,
    relative_bandwidth,
    vqt_filter_fft,
    wavelet_lengths,
)
from .stft import ShortTimeFourierTransform


def _octave_rates(frame_period: int, sample_rate: float, n_octave: int):
    """Each octave's frame period and sample rate, top octave first."""
    fp, sr = [frame_period], [sample_rate * 1.0]
    for i in range(n_octave - 1):
        if fp[i] % 2 == 0:
            fp.append(fp[i] // 2)
            sr.append(sr[i] * 0.5)
        else:
            fp.append(fp[i])
            sr.append(sr[i])
    return fp, sr


def _shared_fft_bases(sr, freqs, slices, alpha, filter_scale, norm,
                      sparsity, window):
    """Each octave's FFT basis at the longest natural FFT length."""
    naturals = [vqt_filter_fft(sr[i], freqs[sl], filter_scale, norm,
                               sparsity, window=window, alpha=alpha[sl])
                for i, sl in enumerate(slices)]
    shared_fft = max(nf for _, nf, _ in naturals)
    bases = []
    for i, sl in enumerate(slices):
        if naturals[i][1] == shared_fft:
            bases.append(naturals[i][0])
        else:
            bases.append(vqt_filter_fft(
                sr[i], freqs[sl], filter_scale, norm, sparsity,
                window=window, alpha=alpha[sl], force_n_fft=shared_fft)[0])
    return bases, shared_fft


def basis_overlap_add(a: torch.Tensor, basis: torch.Tensor,
                      hop: int) -> torch.Tensor:
    """Overlap-add of the frames ``a @ basis`` at ``hop``, normalised by
    the number of frames over each sample and centred (the weighted
    overlap-add of ``Unframe`` with a rectangular window), without forming
    the frames: (..., N, K) x (K, L) -> (..., N * hop)."""
    *batch, N, K = a.shape
    L = basis.shape[-1]
    y = F.conv_transpose1d(a.reshape(-1, N, K).transpose(1, 2),
                           basis[:, None, :], stride=hop)[:, 0]
    t = torch.arange(y.shape[-1], device=a.device)
    last = torch.clamp(torch.div(t, hop, rounding_mode="floor"), max=N - 1)
    first = torch.clamp(-torch.div(L - 1 - t, hop, rounding_mode="floor"),
                        min=0)
    y = y / ((last - first + 1).to(y.dtype) + 1e-16)
    return y[..., L // 2:L // 2 + N * hop].reshape(*batch, N * hop)


def _check_period(frame_period: int) -> None:
    if frame_period <= 0:
        raise ValueError("frame_period must be positive.")


class ConstantQTransform(nn.Module):
    """Waveform (..., T) -> CQT (..., T/P, K) complex."""

    def __init__(self, frame_period: int, sample_rate: int, *,
                 f_min: float = 32.7, n_bin: int = 84,
                 n_bin_per_octave: int = 12, tuning: float = 0,
                 filter_scale: float = 1, norm: float = 1,
                 sparsity: float = 1e-2, window: str = "hann",
                 scale: bool = True, res_type: str | None = "kaiser_best",
                 dtype=None, device=None, **kwargs) -> None:
        super().__init__()
        _check_period(frame_period)
        K, B = n_bin, n_bin_per_octave
        n_octave = int(np.ceil(K / B))
        n_filter = min(B, K)

        freqs = cqt_frequencies(K, f_min, B, tuning)
        alpha = et_relative_bw(B) if K == 1 else relative_bandwidth(freqs)
        lengths, filter_cutoff = wavelet_lengths(
            freqs, sample_rate, window, filter_scale, 0, alpha)

        rkw = get_resample_params(res_type) if res_type is not None else {}
        rkw.update({k: v for k, v in kwargs.items()
                    if k in ("lowpass_filter_width", "rolloff", "beta")})

        self.early_downsample = None
        self.downsample_scale = 1.0
        downsample_count = early_downsample_count(
            sample_rate * 0.5, filter_cutoff, frame_period, n_octave)
        if 0 < downsample_count:
            factor = 2 ** downsample_count
            self.early_downsample = child(Resampler, orig_freq=factor,
                                          new_freq=1, **rkw)
            self.downsample_scale = (float(np.sqrt(factor)) if scale
                                     else float(factor))
            frame_period //= factor
            sample_rate /= factor
            if scale:
                lengths, _ = wavelet_lengths(freqs, sample_rate, window,
                                             filter_scale, 0, alpha)

        self.register_buffer("cqt_scale", torch.as_tensor(
            (1.0 / np.sqrt(lengths)) if scale else np.ones(K)))

        fp, sr = _octave_rates(frame_period, sample_rate, n_octave)
        slices = [slice(-n_filter * (i + 1),
                        None if i == 0 else (-n_filter * i))
                  for i in range(n_octave)]
        bases, fft_length = _shared_fft_bases(
            sr, freqs, slices, alpha, filter_scale, norm, sparsity, window)
        for i, basis in enumerate(bases):
            basis = basis * np.sqrt(sample_rate / sr[i])
            self.register_buffer(f"fft_basis_{i}",
                                 torch.as_tensor(np.ascontiguousarray(
                                     basis.T)))
        self.transforms = nn.ModuleList(
            child(ShortTimeFourierTransform, frame_length=fft_length,
                  frame_period=fp[i], fft_length=fft_length, center=True,
                  window="rectangular", norm="none", eps=0,
                  out_format="complex")
            for i in range(n_octave))
        # Between octaves: halve the rate where the period is even.
        self.halves = nn.ModuleList(
            child(Resampler, orig_freq=2, new_freq=1, **rkw)
            if fp[i] % 2 == 0 else nn.Identity()
            for i in range(n_octave - 1))
        self.halve_scales = [float(np.sqrt(2)) if fp[i] % 2 == 0 else 1.0
                             for i in range(n_octave - 1)]
        place(self, device, dtype)

    @full_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.early_downsample is not None:
            x = self.early_downsample(x) * self.downsample_scale
        cs = []
        for i, stft in enumerate(self.transforms):
            cs.append(torch.matmul(stft(x), getattr(self, f"fft_basis_{i}")))
            if i < len(self.halves):
                x = self.halves[i](x) * self.halve_scales[i]
        return self._trim_stack(self.cqt_scale.shape[0], cs) * self.cqt_scale

    @staticmethod
    def _trim_stack(n_bin: int, cqt_response: list) -> torch.Tensor:
        max_col = min(c.shape[-2] for c in cqt_response)
        pieces = []
        end = n_bin
        for c in cqt_response:
            n_oct = c.shape[-1]
            if end < n_oct:
                pieces.append(c[..., :max_col, -end:])
                break
            pieces.append(c[..., :max_col, :])
            end -= n_oct
        # responses are ordered top octave first; stack low to high
        return torch.cat(pieces[::-1], dim=-1)


class InverseConstantQTransform(nn.Module):
    """CQT (..., T/P, K) -> waveform (..., T)."""

    def __init__(self, frame_period: int, sample_rate: int, *,
                 f_min: float = 32.7, n_bin: int = 84,
                 n_bin_per_octave: int = 12, tuning: float = 0,
                 filter_scale: float = 1, norm: float = 1,
                 sparsity: float = 1e-2, window: str = "hann",
                 scale: bool = True, res_type: str | None = "kaiser_best",
                 dtype=None, device=None, **kwargs) -> None:
        # Extra keywords (the forward transform's resampler options) are
        # accepted and ignored, as the JAX class does.
        super().__init__()
        _check_period(frame_period)
        K, B = n_bin, n_bin_per_octave
        n_octave = int(np.ceil(K / B))

        freqs = cqt_frequencies(K, f_min, B, tuning)
        alpha = et_relative_bw(B) if K == 1 else relative_bandwidth(freqs)
        lengths, _ = wavelet_lengths(freqs, sample_rate, window,
                                     filter_scale, 0, alpha)
        cqt_scale = np.sqrt(lengths) if scale else np.ones(K)
        rkw = get_resample_params(res_type) if res_type is not None else {}

        fp, sr = _octave_rates(frame_period, sample_rate, n_octave)
        fp.reverse()
        sr.reverse()
        # octaves low to high
        self.slices = [slice(B * i, B * i + min(B, K - B * i))
                       for i in range(n_octave)]
        bases, fft_length = _shared_fft_bases(
            sr, freqs, self.slices, alpha, filter_scale, norm, sparsity,
            window)
        for i, (sl, basis) in enumerate(zip(self.slices, bases)):
            basis = np.conj(basis)
            freq_power = 1.0 / np.sum(np.abs(basis) ** 2, axis=1)
            freq_power *= fft_length / lengths[sl]
            basis = basis * freq_power[:, None]
            # irfft(C @ B) = Re(C) @ irfft(B) + Im(C) @ irfft(iB): the
            # octave's inverse FFT folds into one (2K, L) time basis
            # against [Re C | Im C], with the bins' scale folded in too.
            tb = np.concatenate([np.fft.irfft(basis, n=fft_length),
                                 np.fft.irfft(1j * basis, n=fft_length)])
            tb = tb * np.tile(cqt_scale[sl], 2)[:, None]
            self.register_buffer(f"time_basis_{i}", torch.as_tensor(tb))
        self.hops = fp
        self.resamplers = nn.ModuleList(
            child(Resampler, orig_freq=1,
                  new_freq=int(sample_rate // sr[i]), **rkw)
            for i in range(n_octave))
        place(self, device, dtype)

    @full_precision
    def forward(self, c: torch.Tensor,
                out_length: int | None = None) -> torch.Tensor:
        y = None
        for i, sl in enumerate(self.slices):
            C = c[..., sl]
            x = self.resamplers[i](basis_overlap_add(
                torch.cat([C.real, C.imag], dim=-1),
                getattr(self, f"time_basis_{i}"), self.hops[i]))
            if y is None:
                y = x[..., :out_length]
                continue
            end = min(x.shape[-1], y.shape[-1])
            y = torch.cat([y[..., :end] + x[..., :end], y[..., end:]],
                          dim=-1)
        return y
