"""Cepstrum conversions and FFT-cepstrum analysis (counterpart of
``diffsptk_tpu/ops/cep.py``).

All are batched FFT chains on ``torch.fft``; the fftcep aliasing
correction is a fixed-trip Python loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from ..utils.linalg import cexp, clog


class CepstralAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> cepstrum (..., M+1) with iterative
    aliasing correction (fftcep)."""

    def __init__(self, fft_length: int, cep_order: int, *,
                 accel: float = 0.0, n_iter: int = 0, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, cep_order: int, accel: float,
               n_iter: int) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if fft_length < 2 * cep_order:
            raise ValueError("cep_order must be <= fft_length // 2.")
        if accel < 0:
            raise ValueError("accel must be non-negative.")
        if n_iter < 0:
            raise ValueError("n_iter must be non-negative.")

    @staticmethod
    def _design(fft_length: int, cep_order: int, accel: float = 0.0,
                n_iter: int = 0) -> Design:
        CepstralAnalysis._check(fft_length, cep_order, accel, n_iter)
        N = cep_order + 1
        scale = np.ones(N)
        scale[0] = 0.5
        if N == fft_length // 2 + 1:
            scale[N - 1] = 0.5
        return Design(values={"accel": accel, "n_iter": n_iter},
                      arrays={"scale": scale})

    @staticmethod
    def _forward(x: torch.Tensor, *, accel: float, n_iter: int,
                 scale: torch.Tensor) -> torch.Tensor:
        N = scale.shape[-1]
        H = x.shape[-1]
        e = torch.fft.irfft(torch.log(x))
        v = e[..., :N]
        e = F.pad(e[..., N:H], (N, 0))
        for _ in range(n_iter):
            e = torch.fft.hfft(e)
            e = torch.where(e < 0, 0.0, e)
            e = torch.fft.ihfft(e).real
            t = e[..., :N] * (1 + accel)
            v = v + t
            e = e - F.pad(t, (0, H - N))
        return v * scale


class CepstrumToAutocorrelation(BaseOp):
    """c (..., M+1) -> autocorrelation (..., M2+1):
    hfft(exp(2 Re rfft(c)))."""

    def __init__(self, cep_order: int, acr_order: int, n_fft: int = 512,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(cep_order: int, acr_order: int, n_fft: int) -> None:
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if acr_order < 0:
            raise ValueError("acr_order must be non-negative.")
        if n_fft < max(cep_order + 1, acr_order + 1):
            raise ValueError("n_fft must be large enough.")

    @staticmethod
    def _design(cep_order: int, acr_order: int, n_fft: int = 512) -> Design:
        CepstrumToAutocorrelation._check(cep_order, acr_order, n_fft)
        return Design(values={"acr_order": acr_order, "n_fft": n_fft})

    @staticmethod
    def _forward(c: torch.Tensor, *, acr_order: int,
                 n_fft: int) -> torch.Tensor:
        x = torch.exp(2 * torch.fft.rfft(c, n=n_fft).real)
        return torch.fft.hfft(x, norm="forward")[..., : acr_order + 1]

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class CepstrumToMinimumPhaseImpulseResponse(BaseOp):
    """c -> h = Re ifft(cexp(fft(c)))."""

    def __init__(self, cep_order: int, ir_length: int, n_fft: int = 512,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(cep_order: int, ir_length: int, n_fft: int) -> None:
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if ir_length <= 0:
            raise ValueError("ir_length must be positive.")
        if n_fft < max(cep_order + 1, ir_length):
            raise ValueError("n_fft must be large value.")

    @staticmethod
    def _design(cep_order: int, ir_length: int, n_fft: int = 512) -> Design:
        CepstrumToMinimumPhaseImpulseResponse._check(cep_order, ir_length,
                                                     n_fft)
        return Design(values={"ir_length": ir_length, "n_fft": n_fft})

    @staticmethod
    def _forward(c: torch.Tensor, *, ir_length: int,
                 n_fft: int) -> torch.Tensor:
        C = torch.fft.fft(c, n=n_fft)
        return torch.fft.ifft(cexp(C)).real[..., :ir_length]

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class MinimumPhaseImpulseResponseToCepstrum(BaseOp):
    """h -> c = Re ifft(log|fft(h)|), doubled above quefrency 0: the
    inverse of :class:`CepstrumToMinimumPhaseImpulseResponse`."""

    def __init__(self, ir_length: int, cep_order: int, n_fft: int = 512,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = ir_length
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(ir_length: int, cep_order: int, n_fft: int) -> None:
        CepstrumToMinimumPhaseImpulseResponse._check(cep_order, ir_length,
                                                     n_fft)

    @staticmethod
    def _design(ir_length: int, cep_order: int, n_fft: int = 512) -> Design:
        MinimumPhaseImpulseResponseToCepstrum._check(ir_length, cep_order,
                                                     n_fft)
        scale = np.full(cep_order + 1, 2.0)
        scale[0] = 1.0
        return Design(values={"n_fft": n_fft}, arrays={"scale": scale})

    @staticmethod
    def _forward(h: torch.Tensor, *, n_fft: int,
                 scale: torch.Tensor) -> torch.Tensor:
        H = torch.fft.fft(h, n=n_fft)
        c = torch.fft.ifft(clog(H)).real[..., :scale.shape[-1]]
        return c * scale

    def forward(self, h):
        check_size(h.shape[-1], self.in_dim, "length of impulse response")
        return super().forward(h)


class CepstrumToNegativeDerivativeOfPhaseSpectrum(BaseOp):
    """c -> NDPS via a ramp-weighted hfft."""

    def __init__(self, cep_order: int, fft_length: int, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(cep_order: int, fft_length: int) -> None:
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if fft_length // 2 < cep_order:
            raise ValueError("cep_order must be <= fft_length // 2.")
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")

    @staticmethod
    def _design(cep_order: int, fft_length: int) -> Design:
        CepstrumToNegativeDerivativeOfPhaseSpectrum._check(cep_order,
                                                           fft_length)
        ramp = np.arange(cep_order + 1) * 0.5
        if cep_order == fft_length // 2:
            ramp[-1] *= 2.0
        return Design(values={"fft_length": fft_length},
                      arrays={"ramp": ramp})

    @staticmethod
    def _forward(c: torch.Tensor, *, fft_length: int,
                 ramp: torch.Tensor) -> torch.Tensor:
        v = c * ramp
        return torch.fft.hfft(v, n=fft_length)[..., : fft_length // 2 + 1]

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class NegativeDerivativeOfPhaseSpectrumToCepstrum(BaseOp):
    """NDPS -> c via hfft and the inverse ramp."""

    def __init__(self, fft_length: int, cep_order: int, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, cep_order: int) -> None:
        CepstrumToNegativeDerivativeOfPhaseSpectrum._check(cep_order,
                                                           fft_length)

    @staticmethod
    def _design(fft_length: int, cep_order: int) -> Design:
        NegativeDerivativeOfPhaseSpectrumToCepstrum._check(fft_length,
                                                           cep_order)
        half = fft_length // 2
        ramp = np.arange(cep_order + 1, dtype=np.float64) * half
        if cep_order == half:
            ramp[-1] *= 2.0
        ramp[1:] = 1.0 / ramp[1:]
        return Design(arrays={"ramp": ramp})

    @staticmethod
    def _forward(n: torch.Tensor, *, ramp: torch.Tensor) -> torch.Tensor:
        return torch.fft.hfft(n)[..., :ramp.shape[-1]] * ramp

    def forward(self, n):
        check_size(n.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(n)


class CepstralDistance(BaseOp):
    """Cepstral distance ||c1[1:] - c2[1:]|| with mean/sum reductions."""

    def __init__(self, full: bool = False, reduction: str = "mean",
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(reduction: str) -> None:
        if reduction not in ("none", "sum", "mean", "batchmean"):
            raise ValueError(f"reduction {reduction} is not supported.")

    @staticmethod
    def _design(full: bool = False, reduction: str = "mean") -> Design:
        CepstralDistance._check(reduction)
        const = 10 * math.sqrt(2) / math.log(10) if full else 1.0
        return Design(values={"const": const, "reduction": reduction})

    @staticmethod
    def _forward(c1: torch.Tensor, c2: torch.Tensor, *, const: float,
                 reduction: str) -> torch.Tensor:
        distance = torch.linalg.vector_norm(c1[..., 1:] - c2[..., 1:],
                                            dim=-1)
        if reduction == "sum":
            distance = torch.sum(distance)
        elif reduction == "mean":
            distance = torch.mean(distance) / ((c1.shape[-1] - 1) ** 0.5)
        elif reduction == "batchmean":
            distance = torch.mean(distance)
        return const * distance
