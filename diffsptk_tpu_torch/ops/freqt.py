"""Frequency transform: all-pass warping of (mel-)cepstra
(counterpart of ``diffsptk_tpu/ops/freqt.py``).

The warp is a fixed (L1 x L2) matrix built host-side by the SPTK recurrence
A[i, j] = A[i-1, j-1] + alpha * (A[i, j-1] - A[i-1, j]); applying it is
one matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values


def design_freqt(in_order: int, out_order: int, alpha: float) -> np.ndarray:
    """Warp matrix, returned transposed so y = c @ A."""
    L1, L2 = in_order + 1, out_order + 1
    beta = 1.0 - alpha * alpha
    A = np.zeros((L2, L1))
    A[0, :] = alpha ** np.arange(L1)
    if L2 > 1 and L1 > 1:
        A[1, 1:] = A[0, :-1] * beta * np.arange(1, L1)
    for i in range(2, L2):
        for j in range(1, L1):
            A[i, j] = A[i - 1, j - 1] + alpha * (A[i, j - 1] - A[i - 1, j])
    return A.T


class FrequencyTransform(BaseOp):
    """(..., M1+1) cepstrum -> (..., M2+1) warped cepstrum."""

    def __init__(self, in_order: int, out_order: int, alpha: float = 0.0,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = in_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(in_order: int, out_order: int, alpha: float) -> None:
        if in_order < 0:
            raise ValueError("in_order must be non-negative.")
        if out_order < 0:
            raise ValueError("out_order must be non-negative.")
        if 1 <= abs(alpha):
            raise ValueError("alpha must be in (-1, 1).")

    @staticmethod
    def _design(in_order: int, out_order: int, alpha: float = 0.0) -> Design:
        FrequencyTransform._check(in_order, out_order, alpha)
        return Design(arrays={"A": design_freqt(in_order, out_order, alpha)})

    @staticmethod
    def _forward(c: torch.Tensor, *, A: torch.Tensor) -> torch.Tensor:
        return torch.matmul(c, A)

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)
