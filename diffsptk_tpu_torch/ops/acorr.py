"""Autocorrelation (counterpart of ``diffsptk_tpu/ops/acorr.py``).

r = irfft(|rfft(x)|^2) truncated to M+1 -- two batched FFTs.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, check_size, filter_values

FORMATS = {0: "naive", 1: "normalized", 2: "biased", 3: "unbiased"}


class Autocorrelation(BaseOp):
    """Framed waveform (..., L) -> autocorrelation (..., M+1)."""

    def __init__(self, frame_length: int, acr_order: int,
                 out_format: str | int = "naive", dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = frame_length
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(frame_length: int, acr_order: int) -> None:
        if frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if acr_order < 0:
            raise ValueError("acr_order must be non-negative.")
        if frame_length <= acr_order:
            raise ValueError("acr_order must be less than frame_length.")

    @staticmethod
    def _design(frame_length: int, acr_order: int,
                out_format: str | int = "naive") -> Design:
        Autocorrelation._check(frame_length, acr_order)
        out_format = FORMATS.get(out_format, out_format)
        if out_format not in FORMATS.values():
            raise ValueError(f"out_format {out_format} is not supported.")
        return Design(values={"frame_length": frame_length,
                              "acr_order": acr_order,
                              "out_format": out_format})

    @staticmethod
    def _forward(x: torch.Tensor, *, frame_length: int, acr_order: int,
                 out_format: str) -> torch.Tensor:
        fft_length = x.shape[-1] + acr_order
        if fft_length % 2 == 1:
            fft_length += 1
        X = torch.fft.rfft(x, n=fft_length).abs().square()
        r = torch.fft.irfft(X, n=fft_length)[..., :acr_order + 1]
        if out_format == "normalized":
            return r / r[..., :1]
        if out_format == "biased":
            return r / frame_length
        if out_format == "unbiased":
            n = torch.arange(frame_length, frame_length - acr_order - 1, -1,
                             dtype=r.dtype, device=r.device)
            return r / n
        return r

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "frame length")
        return super().forward(x)
