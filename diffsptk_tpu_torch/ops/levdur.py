"""Levinson-Durbin and its reverse (counterpart of
``diffsptk_tpu/ops/levdur.py``).

As in the JAX package, the forward is not the scalar recursion but a
batched symmetric-Toeplitz SPD solve per frame (utils/linalg.spd_solve:
on the card, float32 orders 13..64 at 2048 frames or more take the SPD
solve kernel).  eps*I regularizes float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values
from ..utils.linalg import remove_gain, spd_solve, symmetric_toeplitz


def default_eps(eps: float | None, dtype=None) -> float:
    """eps of the Toeplitz regularization: 1e-5 at float32 and 0 at other
    dtypes when not given, as in the JAX package."""
    if eps is not None:
        return eps
    return 1e-5 if (dtype or torch.get_default_dtype()) == torch.float32 \
        else 0.0


class LevinsonDurbin(BaseOp):
    """Autocorrelation (..., M+1) -> LPC [K, a1..aM]."""

    def __init__(self, lpc_order: int, eps: float | None = None, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(lpc_order, default_eps(eps, dtype)),
                    dtype=dtype, device=device)

    @staticmethod
    def _check(lpc_order: int, eps: float) -> None:
        if lpc_order < 0:
            raise ValueError("lpc_order must be non-negative.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")

    @staticmethod
    def _design(lpc_order: int, eps: float) -> Design:
        LevinsonDurbin._check(lpc_order, eps)
        return Design(arrays={"eye": np.eye(lpc_order) * eps})

    @staticmethod
    def _forward(r: torch.Tensor, *, eye: torch.Tensor) -> torch.Tensor:
        r0, r1 = r[..., :1], r[..., 1:]
        R = symmetric_toeplitz(r[..., :-1]) + eye
        a = spd_solve(R, -r1)
        K = torch.sqrt(torch.sum(r1 * a, dim=-1, keepdim=True) + r0)
        return torch.cat((K, a), dim=-1)

    def forward(self, r):
        check_size(r.shape[-1], self.in_dim, "dimension of autocorrelation")
        return super().forward(r)


class ReverseLevinsonDurbin(BaseOp):
    """LPC -> autocorrelation via r = irfft((K/|A|)^2)."""

    def __init__(self, lpc_order: int, n_fft: int = 512, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lpc_order: int, n_fft: int) -> None:
        if lpc_order < 0:
            raise ValueError("lpc_order must be non-negative.")
        if n_fft <= lpc_order:
            raise ValueError("n_fft must exceed lpc_order.")

    @staticmethod
    def _design(lpc_order: int, n_fft: int = 512) -> Design:
        ReverseLevinsonDurbin._check(lpc_order, n_fft)
        omega = np.linspace(0, np.pi, n_fft)
        m = np.arange(lpc_order + 1)
        phase = np.exp(-1j * omega[None, :] * m[:, None])  # (M+1, n_fft)
        return Design(arrays={"phase_factors": phase})

    @staticmethod
    def _forward(a: torch.Tensor, *,
                 phase_factors: torch.Tensor) -> torch.Tensor:
        M = a.shape[-1] - 1
        K, monic = remove_gain(a, return_gain=True)
        A = torch.sum(monic[..., None] * phase_factors, dim=-2)
        return torch.fft.irfft(torch.square(K / torch.abs(A)))[..., :M + 1]

    def forward(self, a):
        check_size(a.shape[-1], self.in_dim, "dimension of LPC")
        return super().forward(a)
