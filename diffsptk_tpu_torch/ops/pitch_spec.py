"""Pitch-adaptive spectral envelope estimation, CheapTrick (counterpart of
``diffsptk_tpu/ops/pitch_spec.py``).

F0-adaptive Hann window -> power spectrum -> DC correction -> linear
smoothing -> liftering with compensation.  Gradients flow through the
waveform but not F0.  ``algorithm="straight"`` is not ported yet and
raises ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from ..core import child, full_precision, place
from .spec import Spectrum
from .world_common import (
    TAU,
    dc_correction,
    get_windowed_waveform,
    linear_smoothing,
)


@functools.lru_cache(maxsize=8)
def _dither_table(n: int, d: int) -> np.ndarray:
    return np.abs(np.random.default_rng(1)
                  .standard_normal((n, d))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dither_tensor(n: int, d: int, dtype, device) -> torch.Tensor:
    """The dither table on ``device``, made once per shape."""
    return torch.as_tensor(_dither_table(n, d), dtype=dtype, device=device)


class SpectrumExtractionByCheapTrick(nn.Module):
    """CheapTrick spectral envelope (Morise 2015)."""

    def __init__(self, frame_period: int, sample_rate: int, fft_length: int,
                 *, default_f0: float = 500, q1: float = -0.15,
                 eps: float = 0, relative_floor: float | None = None,
                 f0_ceil: float = 1200.0, dtype=None, device=None) -> None:
        super().__init__()
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.fft_length = fft_length

        # GetF0FloorForCheapTrick()
        self.f_min = 3 * sample_rate / (fft_length - 3)
        if default_f0 < self.f_min:
            raise ValueError(f"default_f0 must be at least {self.f_min}.")
        min_fft_length = 2 ** (
            1 + int(np.log(3 * sample_rate / self.f_min + 1) / np.log(2)))
        if fft_length < min_fft_length:
            raise ValueError(f"fft_length must be at least {min_fft_length}.")

        self.q1 = q1
        self.default_f0 = default_f0
        self.f0_ceil = max(f0_ceil, default_f0)
        rate = sample_rate / fft_length
        self.max_boundary = int(self.f0_ceil * (2 / 3) / rate) + 2

        self.spec = child(Spectrum, fft_length=fft_length, eps=eps,
                          relative_floor=relative_floor, out_format="power")
        self.register_buffer("ramp", torch.arange(fft_length,
                                                  dtype=torch.float64))
        place(self, device, dtype)

    def forward(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        f0 = torch.where(f0 <= self.f_min,
                         torch.full_like(f0, self.default_f0),
                         f0).detach()[..., None]
        f0 = torch.clamp(f0, max=self.f0_ceil)

        waveform = get_windowed_waveform(
            x, f0, 3, 0, self.frame_period, self.sample_rate,
            self.fft_length, "hanning", True, 1e-12, self.ramp)

        power_spectrum = self.spec(waveform)
        dc_bins = int(self.f0_ceil / (self.sample_rate / self.fft_length)) + 2
        power_spectrum = dc_correction(power_spectrum, f0, self.sample_rate,
                                       self.fft_length, self.ramp,
                                       max_bins=dc_bins)
        power_spectrum = linear_smoothing(
            power_spectrum, f0 * (2 / 3), self.sample_rate, self.fft_length,
            self.ramp, self.max_boundary)
        # AddInfinitesimalNoise(), and a floor for the log below.
        D = power_spectrum.shape[-1]
        N = power_spectrum.shape[-2]
        tbl = _dither_tensor(N, D, power_spectrum.dtype,
                             power_spectrum.device)
        power_spectrum = power_spectrum + tbl * torch.finfo(
            power_spectrum.dtype).eps
        power_spectrum = torch.clamp(power_spectrum, min=1e-30)

        one_sided = self.fft_length // 2 + 1
        quefrency = self.ramp[:one_sided] / self.sample_rate
        z = f0 * quefrency
        smoothing_lifter = torch.sinc(z)
        smoothing_lifter = torch.cat(
            [torch.ones_like(smoothing_lifter[..., :1]),
             smoothing_lifter[..., 1:]], dim=-1)
        compensation_lifter = (1 - 2 * self.q1) + 2 * self.q1 * torch.cos(
            TAU * z)
        L = self.fft_length
        H = L // 2
        cepstrum = torch.fft.irfft(torch.log(power_spectrum), n=L)[..., :H + 1]
        lifted = cepstrum * smoothing_lifter * compensation_lifter
        return torch.fft.hfft(lifted, n=L)[..., :H + 1]


class PitchAdaptiveSpectralAnalysis(nn.Module):
    """(waveform (..., T), f0 (..., T/P)) -> envelope (..., T/P, L/2+1)."""

    def __init__(self, frame_period: int, sample_rate: int, fft_length: int,
                 algorithm: str = "cheap-trick",
                 out_format: str | int = "power", dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if sample_rate < 8000:
            raise ValueError("sample_rate must be at least 8000 Hz.")
        if fft_length < 1024:
            raise ValueError("fft_length must be at least 1024.")

        if algorithm == "cheap-trick":
            self.extractor = child(
                SpectrumExtractionByCheapTrick, frame_period=frame_period,
                sample_rate=sample_rate, fft_length=fft_length, **kwargs)
        elif algorithm == "straight":
            raise NotImplementedError(
                "algorithm straight is not ported yet")
        else:
            raise ValueError(f"algorithm {algorithm} is not supported.")

        if out_format in (0, "db"):
            self.formatter = lambda x: x * (10 / math.log(10))
        elif out_format in (1, "log-magnitude"):
            self.formatter = lambda x: 0.5 * x
        elif out_format in (2, "magnitude"):
            self.formatter = lambda x: torch.exp(0.5 * x)
        elif out_format in (3, "power"):
            self.formatter = torch.exp
        else:
            raise ValueError(f"out_format {out_format} is not supported.")
        place(self, device, dtype)

    @full_precision
    def forward(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        return self.formatter(self.extractor(x, f0))
