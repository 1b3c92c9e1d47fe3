"""Pseudo MGLSA digital filter (counterpart of
``diffsptk_tpu/ops/mglsadf.py``), multi-stage mode.

The Taylor cascade e^F ~= sum a_i F^i / i!: every stage filters with the
same per-frame coefficients.  Long filters (M+1 > 32) take the folded-plan
cascade, either in plain torch (``cascade="folded"``) or through the CUDA
kernel on the card (``cascade="fused"``); short ones the direct all-zero
filter.  The other modes (single-stage, freq-domain, pade-approx) and
``cascade="stages"`` are not ported yet.

Phase in {minimum, maximum, zero, mixed}.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core import check_size, child, full_precision, place
from ..kernels.mlsa import PRECISIONS, taylor_cascade
from ..kernels.mlsa_cascade import lane_aligned_nfft, taylor_cascade_folded
from ..utils.linalg import remove_gain
from .gnorm import get_gamma
from .linear_intpl import linear_interpolate
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from .zerodf import AllZeroDigitalFilter

_NOT_PORTED_MODES = ("single-stage", "freq-domain", "pade-approx")


def mirror(x: torch.Tensor, half: bool = False) -> torch.Tensor:
    x0, x1 = x[..., :1], x[..., 1:]
    if half:
        x1 = x1 * 0.5
    return torch.cat((torch.flip(x1, (-1,)), x0, x1), dim=-1)


def _exp_taylor_weights(order: int) -> np.ndarray:
    """weights[i] = cp[i]/cp[i-1] for cp = Taylor coefficients of exp
    (i.e. 1/i), with weights[0] = 1."""
    cp = np.array([1.0 / math.factorial(k) for k in range(order + 1)])
    w = cp[1:] / cp[:-1]
    return np.insert(w, 0, 1.0)


class MultiStageFIRFilter(nn.Module):
    """Taylor-series cascade of time-varying FIR stages."""

    def __init__(self, filter_order, frame_period, *, alpha=0.0, gamma=0.0,
                 ignore_gain=False, phase="minimum", taylor_order=20,
                 cep_order=199, n_fft=512, cascade="folded",
                 cascade_precision=None, learnable=False, dtype=None,
                 device=None):
        super().__init__()
        if taylor_order < 0:
            raise ValueError("taylor_order must be non-negative.")
        if cascade not in ("stages", "folded", "fused"):
            raise ValueError(
                "cascade must be 'stages', 'folded', or 'fused'.")
        if cascade == "stages":
            raise NotImplementedError(
                "cascade='stages' (stage-by-stage FFT FIR) is not ported "
                "yet; use 'folded' or 'fused'")
        if cascade_precision is not None and \
                cascade_precision not in PRECISIONS:
            raise ValueError(f"cascade_precision must be in {PRECISIONS}")
        self.ignore_gain = ignore_gain
        self.phase = phase
        self.frame_period = frame_period
        # "folded": plain torch matmul plans; "fused": the CUDA cascade
        # kernel on the card.  The same math; every matmul is full fp32
        # whatever cascade_precision says.
        self.cascade = cascade
        self.cascade_precision = cascade_precision

        if alpha == 0 and gamma == 0:
            cep_order = filter_order

        if phase == "minimum":
            cep_orders = (cep_order, 0)
        elif phase == "maximum":
            cep_orders = (0, cep_order)
        elif phase == "zero":
            cep_orders = (cep_order, cep_order)
        elif phase == "mixed":
            cep_orders = ((cep_order, cep_order)
                          if isinstance(cep_order, int) else cep_order)
        else:
            raise ValueError(f"phase {phase} is not supported.")
        self.cep_orders = cep_orders

        def mgc2c(order, out_order):
            return child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                         in_order=order, out_order=out_order,
                         in_alpha=alpha, in_gamma=gamma, n_fft=n_fft)

        if phase == "mixed":
            self.mgc2c = nn.ModuleList(
                [mgc2c(filter_order[i], cep_orders[i]) for i in range(2)])
        else:
            self.mgc2c = mgc2c(filter_order, cep_order)

        self.zerodf = child(AllZeroDigitalFilter,
                            filter_order=sum(cep_orders),
                            frame_period=frame_period, ignore_gain=False,
                            zeroth_index=cep_orders[1])

        self.register_buffer(
            "weights", torch.as_tensor(_exp_taylor_weights(taylor_order)))
        a = torch.ones(taylor_order + 1, dtype=torch.float64)
        if learnable:
            self.a = nn.Parameter(a)
        else:
            self.register_buffer("a", a)
        place(self, device, dtype)

    @full_precision
    def forward(self, x, mc, a=None):
        a = self.a if a is None else a
        if self.phase == "mixed":
            mc_min, mc_max = mc
            c_min = self.mgc2c[0](mc_min)
            c_max = self.mgc2c[1](mc_max)
            c0 = c_min[..., :1] + c_max[..., :1]
            c = torch.cat([torch.flip(c_max[..., 1:], (-1,)),
                           torch.zeros_like(c0), c_min[..., 1:]], dim=-1)
        else:
            c = self.mgc2c(mc)
            c0, c = remove_gain(c, value=0.0, return_gain=True)
            if self.phase == "maximum":
                c = torch.flip(c, (-1,))
            elif self.phase == "zero":
                c = mirror(c, half=True)

        M = c.shape[-1] - 1
        if M + 1 > 32:
            # Every Taylor stage filters with the same coefficients, so
            # the per-frame coefficient spectrum is shared across stages.
            P = self.frame_period
            advance = self.zerodf.padding[1]
            nfft = lane_aligned_nfft(2 * P + M + 1)
            if self.cascade == "fused" and x.dtype == torch.float32:
                # The cascade kernel takes float32; other dtypes take the
                # folded form, as in the JAX package.
                kw = ({"precision": self.cascade_precision}
                      if self.cascade_precision else {})
                y = taylor_cascade(x, c, self.weights, a, P, advance, nfft,
                                   **kw)
            else:
                y = taylor_cascade_folded(x, c, self.weights, a, P, advance,
                                          nfft)
        else:
            y = x * a[0]
            for i in range(1, a.shape[0]):
                x = self.zerodf(x, c) * self.weights[i]
                y = y + x * a[i]

        if not self.ignore_gain:
            K = torch.exp(linear_interpolate(c0, self.frame_period))
            y = y * K[..., 0]
        return y


class PseudoMGLSADigitalFilter(nn.Module):
    """MLSA/MGLSA filter: (excitation (..., T), mel-cepstrum
    (..., T/P, M+1)) -> (..., T)."""

    def __init__(self, filter_order, frame_period: int, *, alpha: float = 0,
                 gamma: float = 0, c: int | None = None,
                 ignore_gain: bool = False, phase: str = "minimum",
                 mode: str = "multi-stage", dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        self.frame_period = frame_period

        if phase == "mixed":
            if isinstance(filter_order, int):
                filter_order = (filter_order, filter_order)
            self.split_sections = (filter_order[0], filter_order[1] + 1)
        else:
            if not isinstance(filter_order, int):
                raise ValueError(
                    "filter_order must be int unless phase is 'mixed'.")
            self.split_sections = (filter_order + 1,)
        gamma = get_gamma(gamma, c)

        def flip(v):
            return v if isinstance(v, int) else (v[1], v[0])

        kw = kwargs.copy()
        for key in ("cep_order", "ir_length"):
            if key in kw:
                kw[key] = flip(kw[key])
        fo = flip(filter_order)

        common = dict(alpha=alpha, gamma=gamma, ignore_gain=ignore_gain,
                      phase=phase)
        if mode == "multi-stage":
            self.mglsadf = MultiStageFIRFilter(fo, frame_period, **common,
                                               **kw, device=device,
                                               dtype=dtype)
        elif mode in _NOT_PORTED_MODES:
            raise NotImplementedError(f"mode {mode} is not ported yet")
        else:
            raise ValueError(f"mode {mode} is not supported.")

    def forward(self, x: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        check_size(mc.shape[-1], sum(self.split_sections),
                   "dimension of mel-cepstrum")
        check_size(x.shape[-1], mc.shape[-2] * self.frame_period,
                   "sequence length")
        if len(self.split_sections) != 1:
            n = self.split_sections[0]
            mc_max, mc_min = mc[..., :n], mc[..., n:]
            mc_max = torch.nn.functional.pad(torch.flip(mc_max, (-1,)),
                                             (1, 0))
            mc_inner = (mc_min, mc_max)
        else:
            mc_inner = mc
        return self.mglsadf(x, mc_inner)


class PseudoInverseMGLSADigitalFilter(nn.Module):
    """IMLSA: literally mglsadf(y, -mc)."""

    def __init__(self, filter_order, frame_period: int, **kwargs) -> None:
        super().__init__()
        self.mglsadf = PseudoMGLSADigitalFilter(filter_order, frame_period,
                                                **kwargs)

    def forward(self, y: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        return self.mglsadf(y, -mc)
