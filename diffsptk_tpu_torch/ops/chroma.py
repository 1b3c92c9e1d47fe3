"""Chroma filterbank analysis (counterpart of
``diffsptk_tpu/ops/chroma.py``; the design is a copy of the JAX
package's, after librosa's ``filters.chroma``)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values


def design_chroma(sr: float, n_fft: int, n_chroma: int = 12,
                  tuning: float = 0.0, ctroct: float = 5.0,
                  octwidth: float | None = 2, norm: float | None = 2,
                  base_c: bool = True) -> np.ndarray:
    """Gaussian-bump chroma weights (n_chroma, n_fft//2+1)."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    A440 = 440.0 * 2.0 ** (tuning / n_chroma)
    octs = np.log2(frequencies / (A440 / 16))
    frqbins = n_chroma * octs
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidth = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0),
                               [1.0]))
    D = np.subtract.outer(frqbins, np.arange(n_chroma, dtype="d")).T
    half = np.round(float(n_chroma) / 2)
    D = np.remainder(D + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidth, (n_chroma, 1))) ** 2)
    if norm is not None:
        mag = np.sum(np.abs(wts) ** norm, axis=0) ** (1.0 / norm)
        wts = wts / np.maximum(mag, np.finfo(np.float64).tiny)
    if octwidth is not None:
        wts = wts * np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)])


class ChromaFilterBankAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> chroma (..., C), normalized."""

    def __init__(self, *, fft_length: int, n_channel: int, sample_rate: int,
                 norm: float = float("inf"), use_power: bool = True,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, n_channel: int, sample_rate: int) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if n_channel <= 0:
            raise ValueError("n_channel must be positive.")
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive.")

    @staticmethod
    def _design(fft_length: int, n_channel: int, sample_rate: int,
                norm: float = float("inf"), use_power: bool = True) -> Design:
        ChromaFilterBankAnalysis._check(fft_length, n_channel, sample_rate)
        H = design_chroma(sample_rate, fft_length, n_channel).T
        return Design(values={"norm": norm, "use_power": use_power},
                      arrays={"H": H})

    @staticmethod
    def _forward(x: torch.Tensor, *, norm: float, use_power: bool,
                 H: torch.Tensor) -> torch.Tensor:
        y = x if use_power else torch.sqrt(x)
        y = torch.matmul(y, H)
        if np.isinf(norm):
            denom = torch.amax(torch.abs(y), dim=-1, keepdim=True)
        else:
            denom = torch.sum(torch.abs(y) ** norm, dim=-1,
                              keepdim=True) ** (1.0 / norm)
        return y / torch.clamp(denom, min=1e-12)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)
