"""Mel-generalized cepstrum -> spectrum (counterpart of
``diffsptk_tpu/ops/mgc2sp.py``).

mgc2mgc to the plain cepstrum, then one rfft; seven real output formats
and the complex spectrum (which the frequency-domain MLSA mode takes).
"""

from __future__ import annotations

import math

import torch

from ..core import BaseOp, Design, check_size, child, filter_values
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum


def _make_formatter(out_format):
    if out_format in (0, "db"):
        return lambda x: x.real * (20 / math.log(10))
    if out_format in (1, "log-magnitude"):
        return lambda x: x.real
    if out_format in (2, "magnitude"):
        return lambda x: torch.exp(x.real)
    if out_format in (3, "power"):
        return lambda x: torch.exp(2 * x.real)
    if out_format in (4, "cycle"):
        return lambda x: x.imag / math.pi
    if out_format in (5, "radian"):
        return lambda x: x.imag
    if out_format in (6, "degree"):
        return lambda x: x.imag * (180 / math.pi)
    if out_format == "complex":
        return lambda x: torch.exp(x.real) * torch.exp(1j * x.imag)
    raise ValueError(f"out_format {out_format} is not supported.")


class MelGeneralizedCepstrumToSpectrum(BaseOp):
    """(..., M+1) -> (..., L/2+1)."""

    def __init__(self, cep_order: int, fft_length: int, *, alpha: float = 0,
                 gamma: float = 0, norm: bool = False, mul: bool = False,
                 n_fft: int = 512, out_format: str | int = "power",
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, fft_length: int, alpha: float = 0,
                gamma: float = 0, norm: bool = False, mul: bool = False,
                n_fft: int = 512, out_format: str | int = "power") -> Design:
        formatter = _make_formatter(out_format)
        mgc2c = child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                      in_order=cep_order, in_alpha=alpha, in_gamma=gamma,
                      in_norm=norm, in_mul=mul, out_order=fft_length // 2,
                      n_fft=n_fft)
        return Design(values={"formatter": formatter},
                      layers={"mgc2c": mgc2c})

    @staticmethod
    def _forward(mc: torch.Tensor, *, formatter, mgc2c) -> torch.Tensor:
        c = mgc2c(mc)
        return formatter(torch.fft.rfft(c, n=(c.shape[-1] - 1) * 2))

    def forward(self, mc):
        check_size(mc.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(mc)
