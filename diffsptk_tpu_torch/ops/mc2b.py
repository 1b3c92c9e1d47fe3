"""Mel-cepstrum <-> MLSA filter coefficients (counterpart of
``diffsptk_tpu/ops/mc2b.py``).

mc2b:  b(M) = mc(M); b(m) = mc(m) - alpha * b(m+1), one matmul with the
upper-triangular matrix of powers of -alpha that the recursion unrolls to.
b2mc:  mc(m) = b(m) + alpha * b(m+1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values


def _check_order_alpha(cep_order: int, alpha: float) -> None:
    if cep_order < 0:
        raise ValueError("cep_order must be non-negative.")
    if 1 <= abs(alpha):
        raise ValueError("alpha must be in (-1, 1).")


class MelCepstrumToMLSADigitalFilterCoefficients(BaseOp):
    """Mel-cepstrum (..., M+1) -> MLSA filter coefficients (..., M+1)."""

    def __init__(self, cep_order: int, alpha: float = 0.0, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, alpha: float = 0.0) -> Design:
        _check_order_alpha(cep_order, alpha)
        i = np.arange(cep_order + 1)
        d = i[None, :] - i[:, None]
        A = np.where(d >= 0, (-alpha) ** np.maximum(d, 0), 0.0)
        return Design(arrays={"A": A.T})

    @staticmethod
    def _forward(mc: torch.Tensor, *, A: torch.Tensor) -> torch.Tensor:
        return torch.matmul(mc, A)

    def forward(self, mc):
        check_size(mc.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(mc)


class MLSADigitalFilterCoefficientsToMelCepstrum(BaseOp):
    """Inverse of :class:`MelCepstrumToMLSADigitalFilterCoefficients`."""

    def __init__(self, cep_order: int, alpha: float = 0.0, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, alpha: float = 0.0) -> Design:
        _check_order_alpha(cep_order, alpha)
        return Design(values={"alpha": alpha})

    @staticmethod
    def _forward(b: torch.Tensor, *, alpha: float) -> torch.Tensor:
        return b + F.pad(alpha * b[..., 1:], (0, 1))

    def forward(self, b):
        check_size(b.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(b)
