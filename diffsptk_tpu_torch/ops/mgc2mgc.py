"""Mel-generalized cepstrum converter
(counterpart of ``diffsptk_tpu/ops/mgc2mgc.py``).

The (alpha, gamma, norm, mul) source/target combination compiles at design
time into a fixed chain of stages: gamma (de)multiplication, gain
(de)normalization, all-pass warping (a freqt matmul), and the gc2gc
exp/log composition on an FFT grid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, child, filter_values
from ..utils.linalg import cexp, clog
from .freqt import FrequencyTransform
from .gnorm import gnorm, ignorm


def gc2gc(c1: torch.Tensor, out_order: int, in_gamma: float,
          out_gamma: float, n_fft: int = 512) -> torch.Tensor:
    """Generalized-cepstrum power change in the gain-normalized domain:
    C2 = s^{-1}_gamma2(s_gamma1(C1)) evaluated on an n_fft grid."""
    c01 = F.pad(c1[..., 1:], (1, 0))
    C1 = torch.fft.fft(c01, n=n_fft)

    if in_gamma == 0:
        sC1 = cexp(C1)
    else:
        C1 = C1 * in_gamma + 1.0
        r = torch.abs(C1) ** (1.0 / in_gamma)
        theta = torch.angle(C1) / in_gamma
        sC1 = r * torch.exp(1j * theta)

    if out_gamma == 0:
        C2 = clog(sC1)
    else:
        r = torch.abs(sC1) ** out_gamma
        theta = torch.angle(sC1) * out_gamma
        C2 = (r * torch.cos(theta) - 1.0) / out_gamma

    c02 = torch.fft.ifft(C2).real[..., : out_order + 1]
    return torch.cat((c1[..., :1], 2 * c02[..., 1:]), dim=-1)


def _gamma_div(gamma):
    return lambda c: torch.cat((c[..., :1], c[..., 1:] / gamma), dim=-1)


def _gamma_mul(gamma):
    return lambda c: torch.cat((c[..., :1], c[..., 1:] * gamma), dim=-1)


def _zeroth_gamma_div(gamma):
    return lambda c: torch.cat(((c[..., :1] - 1) / gamma, c[..., 1:]), dim=-1)


def _zeroth_gamma_mul(gamma):
    return lambda c: torch.cat((c[..., :1] * gamma + 1, c[..., 1:]), dim=-1)


def _gnorm(gamma):
    return lambda c: gnorm(c, gamma)


def _ignorm(gamma):
    return lambda c: ignorm(c, gamma)


class MelGeneralizedCepstrumToMelGeneralizedCepstrum(BaseOp):
    """(..., M1+1) mel-generalized cepstrum -> (..., M2+1)."""

    def __init__(self, in_order: int, out_order: int, in_alpha: float = 0,
                 out_alpha: float = 0, in_gamma: float = 0,
                 out_gamma: float = 0, in_norm: bool = False,
                 out_norm: bool = False, in_mul: bool = False,
                 out_mul: bool = False, n_fft: int = 512,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = in_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(in_order, out_order, in_alpha, out_alpha, in_gamma,
               out_gamma, in_mul, n_fft) -> None:
        if in_order < 0 or out_order < 0:
            raise ValueError("order must be non-negative.")
        if 1 <= abs(in_alpha) or 1 <= abs(out_alpha):
            raise ValueError("alpha must be in (-1, 1).")
        if 1 < abs(in_gamma) or 1 < abs(out_gamma):
            raise ValueError("gamma must be in [-1, 1].")
        if n_fft <= max(in_order, out_order) + 1:
            raise ValueError("n_fft must be much larger than cepstrum order.")
        if in_gamma == 0 and in_mul:
            raise ValueError("Invalid combination of in_gamma and in_mul.")

    @staticmethod
    def _design(in_order: int, out_order: int, in_alpha: float = 0,
                out_alpha: float = 0, in_gamma: float = 0,
                out_gamma: float = 0, in_norm: bool = False,
                out_norm: bool = False, in_mul: bool = False,
                out_mul: bool = False, n_fft: int = 512) -> Design:
        M = MelGeneralizedCepstrumToMelGeneralizedCepstrum
        M._check(in_order, out_order, in_alpha, out_alpha, in_gamma,
                 out_gamma, in_mul, n_fft)

        def to_gc(c):
            return gc2gc(c, out_order, in_gamma, out_gamma, n_fft)

        seq = []
        layers = {}
        if not in_norm and in_mul:
            seq.append(_zeroth_gamma_div(in_gamma))

        alpha = (out_alpha - in_alpha) / (1 - in_alpha * out_alpha)
        if alpha == 0:
            if in_order == out_order and in_gamma == out_gamma:
                if not in_mul and out_mul:
                    seq.append(_gamma_mul(in_gamma))
                if not in_norm and out_norm:
                    seq.append(_gnorm(in_gamma))
                if in_norm and not out_norm:
                    seq.append(_ignorm(out_gamma))
                if in_mul and not out_mul:
                    seq.append(_gamma_div(out_gamma))
            else:
                if in_mul:
                    seq.append(_gamma_div(in_gamma))
                if not in_norm:
                    seq.append(_gnorm(in_gamma))
                seq.append(to_gc)
                if not out_norm:
                    seq.append(_ignorm(out_gamma))
                if out_mul:
                    seq.append(_gamma_mul(out_gamma))
        else:
            if in_mul:
                seq.append(_gamma_div(in_gamma))
            if in_norm:
                seq.append(_ignorm(in_gamma))
            freqt = child(FrequencyTransform, in_order=in_order,
                          out_order=out_order, alpha=alpha)
            layers["freqt"] = freqt
            seq.append(freqt)
            if out_norm or in_gamma != out_gamma:
                seq.append(_gnorm(in_gamma))
            if in_gamma != out_gamma:
                seq.append(to_gc)
            if not out_norm and in_gamma != out_gamma:
                seq.append(_ignorm(out_gamma))
            if out_mul:
                seq.append(_gamma_mul(out_gamma))

        if not out_norm and out_mul:
            seq.append(_zeroth_gamma_mul(out_gamma))
        return Design(values={"seq": tuple(seq)}, layers=layers)

    @staticmethod
    def _forward(mc: torch.Tensor, *, seq, freqt=None) -> torch.Tensor:
        for layer in seq:
            mc = layer(mc)
        return mc

    def forward(self, mc):
        check_size(mc.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(mc)
