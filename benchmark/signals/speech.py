"""Synthetic voiced speech, made on the device from a seed.

chip_smoke.py's ``synth_speech`` (commit 2f79b3d), drawn on the device in
a few large calls: per row, a pulse train whose f0 glides linearly from
90-140 Hz to 180-260 Hz over the row, through a cascade of three
formant resonators (700, 1,220 and 2,600 Hz, each moved by up to 15 % a
row; bandwidths 130, 70 and 160 Hz), scaled to a peak of 0.5, plus white
noise of standard deviation 1e-3.  The resonators are applied as their
impulse responses, truncated where they fall below 1e-9 of their peak,
by one FFT convolution.  Every seed gives rows of the same sizes; only
their content changes.
"""

from __future__ import annotations

import math

import torch

FORMANTS = ((700.0, 130.0), (1220.0, 70.0), (2600.0, 160.0))
JITTER = 0.15
NOISE = 1e-3


def make(gen: torch.Generator, rows: int, samples: int, sample_rate: int,
         device) -> torch.Tensor:
    """(rows, samples) float32 on ``device``, drawn from ``gen``."""
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.rand((rows, 2 + len(FORMANTS)), generator=gen, **f64)
    f0_start = 90.0 + 50.0 * u[:, :1]
    f0_end = 180.0 + 80.0 * u[:, 1:2]
    ramp = torch.arange(samples, **f64) / max(samples - 1, 1)
    f0 = f0_start + (f0_end - f0_start) * ramp
    phase = torch.cumsum(f0 / sample_rate, dim=-1)
    pulses = torch.diff(torch.floor(phase), dim=-1,
                        prepend=torch.zeros((rows, 1), **f64))

    slowest = min(math.exp(-math.pi * bw / sample_rate)
                  for _, bw in FORMANTS)
    taps = int(math.ceil(math.log(1e-9) / math.log(slowest)))
    nfft = 1 << (samples + taps - 1).bit_length()
    n = torch.arange(taps, **f64)
    spectrum = torch.ones((rows, nfft // 2 + 1), dtype=torch.complex128,
                          device=device)
    for i, (freq, bw) in enumerate(FORMANTS):
        f = freq * (1.0 + JITTER * (2.0 * u[:, 2 + i:3 + i] - 1.0))
        theta = 2.0 * math.pi * f / sample_rate
        r = math.exp(-math.pi * bw / sample_rate)
        h = r ** n * torch.sin((n + 1) * theta) / torch.sin(theta)
        spectrum = spectrum * torch.fft.rfft(h, n=nfft)
    x = torch.fft.irfft(torch.fft.rfft(pulses, n=nfft) * spectrum,
                        n=nfft)[:, :samples]
    x = 0.5 * x / x.abs().amax(dim=-1, keepdim=True)
    x = x + NOISE * torch.randn((rows, samples), generator=gen, **f64)
    return x.to(torch.float32)
