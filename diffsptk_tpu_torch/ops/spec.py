"""Power/amplitude spectrum (counterpart of ``diffsptk_tpu/ops/spec.py``).

Computes K·|B|/|A| style spectra from waveform coefficients b and/or filter
denominator a, with eps flooring and an optional relative floor in dB.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, child, filter_values
from ..utils.linalg import remove_gain
from .fftr import RealValuedFastFourierTransform


def _make_formatter(out_format):
    if out_format in (0, "db"):
        return lambda x: 10.0 * torch.log10(x)
    if out_format in (1, "log-magnitude"):
        return lambda x: 0.5 * torch.log(x)
    if out_format in (2, "magnitude"):
        return lambda x: torch.sqrt(x)
    if out_format in (3, "power"):
        return lambda x: x
    raise ValueError(f"out_format {out_format} is not supported.")


class Spectrum(BaseOp):
    """Spectrum of b (numerator) and/or a (denominator), (..., N) ->
    (..., L/2+1)."""

    def __init__(self, fft_length: int, *, eps: float = 0.0,
                 relative_floor: float | None = None,
                 out_format: str | int = "power", learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, eps: float,
               relative_floor: float | None) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")
        if relative_floor is not None and 0 <= relative_floor:
            raise ValueError("relative_floor must be negative.")

    @staticmethod
    def _design(fft_length: int, eps: float = 0.0,
                relative_floor: float | None = None,
                out_format: str | int = "power",
                learnable: bool = False) -> Design:
        Spectrum._check(fft_length, eps, relative_floor)
        if relative_floor is not None:
            relative_floor = 10.0 ** (relative_floor / 10.0)
        fftr = child(RealValuedFastFourierTransform, fft_length=fft_length,
                     out_format="amplitude", learnable=learnable)
        return Design(
            values={"eps": eps, "relative_floor": relative_floor,
                    "formatter": _make_formatter(out_format)},
            layers={"fftr": fftr})

    @staticmethod
    def _forward(b=None, a=None, *, eps, relative_floor, formatter, fftr):
        if b is not None and a is not None:
            K, a = remove_gain(a, return_gain=True)
            X = K * (fftr(b) / fftr(a))
        elif b is not None:
            X = fftr(b)
        elif a is not None:
            K, a = remove_gain(a, return_gain=True)
            X = K / fftr(a)
        else:
            raise ValueError("Either b or a must be specified.")
        s = torch.square(X) + eps
        if relative_floor is not None:
            m = torch.amax(s, dim=-1, keepdim=True)
            s = torch.maximum(s, m * relative_floor)
        return formatter(s)
