"""PARCOR-domain conversions (counterpart of ``diffsptk_tpu/ops/parcor.py``).

The step-up and step-down recursions run as Python loops over the (small)
order, each step one batched torch expression; the elementwise pairs are
single torch ops.  Index 0 of every vector is the gain K and is passed
through (or transformed) as SPTK does.
"""

from __future__ import annotations

import math

import torch

from ..core import BaseOp, Design, check_size, filter_values
from .gnorm import get_gamma


def _check_order_gamma(order: int, gamma: float, c: int | None) -> None:
    if order < 0:
        raise ValueError("order must be non-negative.")
    if 1 < abs(gamma):
        raise ValueError("gamma must be in [-1, 1].")
    if c is not None and c != 0 and c < 1:
        raise ValueError("c must be greater than or equal to 1.")


def lpc2par(a: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """LPC -> PARCOR by the Levinson step-down recursion."""
    M = a.shape[-1] - 1
    K, cur = a[..., :1], a[..., 1:] * gamma
    ks = []
    for m in reversed(range(M)):
        km = cur[..., m:m + 1]
        ks.append(km)
        if m == 0:
            break
        head = cur[..., :-1]
        cur = (head - km * torch.flip(head, (-1,))) / (1 - km * km)
    ks.append(K)
    return torch.cat(ks[::-1], dim=-1)


def par2lpc(k: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """PARCOR -> LPC by the Levinson step-up recursion."""
    a = k / gamma
    for m in range(2, k.shape[-1]):
        km = k[..., m:m + 1]
        am = a[..., 1:m]
        a = torch.cat([a[..., :1], am + km * torch.flip(am, (-1,)),
                       a[..., m:]], dim=-1)
    return a


class _LevinsonRecursion(BaseOp):
    """Shared: an order, a gamma (or c), and one of the recursions."""

    _what = "LPC"

    def __init__(self, lpc_order: int, gamma: float = 1.0,
                 c: int | None = None, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lpc_order: int, gamma: float, c: int | None) -> None:
        _check_order_gamma(lpc_order, gamma, c)

    @staticmethod
    def _design(lpc_order: int, gamma: float = 1.0,
                c: int | None = None) -> Design:
        _check_order_gamma(lpc_order, gamma, c)
        return Design(values={"gamma": get_gamma(gamma, c)})

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, f"dimension of {self._what}")
        return super().forward(x)


class LinearPredictiveCoefficientsToParcorCoefficients(_LevinsonRecursion):
    """LPC (..., M+1) -> PARCOR (..., M+1)."""

    @staticmethod
    def _forward(a: torch.Tensor, *, gamma: float) -> torch.Tensor:
        return lpc2par(a, gamma)


class ParcorCoefficientsToLinearPredictiveCoefficients(_LevinsonRecursion):
    """PARCOR (..., M+1) -> LPC (..., M+1)."""

    _what = "PARCOR"

    @staticmethod
    def _forward(k: torch.Tensor, *, gamma: float) -> torch.Tensor:
        return par2lpc(k, gamma)


class _GainPreservingElementwise(BaseOp):
    """Shared: transform the tail, pass the gain through."""

    def __init__(self, par_order: int, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = par_order + 1
        self._setup(self._design(par_order), dtype=dtype, device=device)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of input")
        return super().forward(x)

    @staticmethod
    def _check(par_order: int) -> None:
        if par_order < 0:
            raise ValueError("par_order must be non-negative.")

    @classmethod
    def _design(cls, par_order: int) -> Design:
        cls._check(par_order)
        return Design()


class ParcorCoefficientsToInverseSine(_GainPreservingElementwise):
    """PARCOR -> inverse-sine coefficients (2/pi) asin(k)."""

    @staticmethod
    def _forward(k: torch.Tensor) -> torch.Tensor:
        tail = torch.clamp(k[..., 1:], -1 + 1e-6, 1 - 1e-6)
        return torch.cat((k[..., :1], (2 / math.pi) * torch.asin(tail)),
                         dim=-1)


class InverseSineToParcorCoefficients(_GainPreservingElementwise):
    """Inverse of :class:`ParcorCoefficientsToInverseSine`."""

    @staticmethod
    def _forward(s: torch.Tensor) -> torch.Tensor:
        return torch.cat((s[..., :1], torch.sin((math.pi / 2) * s[..., 1:])),
                         dim=-1)


class ParcorCoefficientsToLogAreaRatio(_GainPreservingElementwise):
    """PARCOR -> log area ratio 2 artanh(k)."""

    @staticmethod
    def _forward(k: torch.Tensor) -> torch.Tensor:
        return torch.cat((k[..., :1], 2.0 * torch.atanh(k[..., 1:])), dim=-1)


class LogAreaRatioToParcorCoefficients(_GainPreservingElementwise):
    """Inverse of :class:`ParcorCoefficientsToLogAreaRatio`."""

    @staticmethod
    def _forward(g: torch.Tensor) -> torch.Tensor:
        return torch.cat((g[..., :1], torch.tanh(0.5 * g[..., 1:])), dim=-1)


class AllPoleToAllZeroDigitalFilterCoefficients(_GainPreservingElementwise):
    """norm0: b0 = 1/K, b = a/K (self-inverse)."""

    def __init__(self, filter_order: int, dtype=None, device=None) -> None:
        super().__init__(filter_order, dtype=dtype, device=device)

    @staticmethod
    def _check(filter_order: int) -> None:
        if filter_order < 0:
            raise ValueError("filter_order must be non-negative.")

    @staticmethod
    def _forward(a: torch.Tensor) -> torch.Tensor:
        K, tail = a[..., :1], a[..., 1:]
        b0 = 1.0 / K
        return torch.cat((b0, tail * b0), dim=-1)


AllZeroToAllPoleDigitalFilterCoefficients = (
    AllPoleToAllZeroDigitalFilterCoefficients)
