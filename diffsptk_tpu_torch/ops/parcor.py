"""PARCOR-domain conversions (counterpart of ``diffsptk_tpu/ops/parcor.py``).

Only the gain-preserving elementwise base and ``norm0``
(AllPoleToAllZeroDigitalFilterCoefficients) are ported so far.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, check_size


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
