"""Composite sinusoidal model conversions (counterpart of
``diffsptk_tpu/ops/csm.py``).

The two small linear solves take ``torch.linalg.solve_ex`` without its
error check, so that nothing is read back to the host; the roots come
from rootpol's Aberth iteration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values
from ..utils.linalg import hankel, vander
from .rootpol import aberth_roots


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


class AutocorrelationToCompositeSinusoidalModelCoefficients(BaseOp):
    """r (..., M+1), M odd -> [frequencies, intensities] (..., M+1)."""

    def __init__(self, acr_order: int, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = acr_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(acr_order: int) -> None:
        if acr_order <= 0 or acr_order % 2 == 0:
            raise ValueError("acr_order must be a positive odd number.")
        if 30 < acr_order:
            raise ValueError(
                "acr_order must be small due to computational accuracy.")

    @staticmethod
    def _design(acr_order: int) -> Design:
        AutocorrelationToCompositeSinusoidalModelCoefficients._check(
            acr_order)
        N = acr_order + 1
        B = np.zeros((N, N))
        for n in range(N):
            z = 2.0 ** -n
            for k in range(n + 1):
                B[k, n] = math.comb(n, k) * z
        C = np.zeros((N, N))
        for k in range(N):
            bias = k % 2
            center = k // 2
            length = center + 1
            C[bias:bias + 2 * length:2, k] = B[bias + center:
                                               bias + center + length, k]
        C[1:] *= 2
        return Design(arrays={"C": C})

    @staticmethod
    def _forward(r: torch.Tensor, *, C: torch.Tensor) -> torch.Tensor:
        u = torch.matmul(r, C)
        n = u.shape[-1] // 2
        u1, u2 = u[..., :n], u[..., n:]
        p = _solve(hankel(-u), u2)
        coefs = torch.cat((torch.ones_like(p[..., :1]),
                           torch.flip(p, (-1,))), dim=-1)
        x = -torch.sort(-aberth_roots(coefs).real, dim=-1).values
        m = _solve(vander(x), u1)
        return torch.cat((torch.arccos(x), m), dim=-1)

    def forward(self, r):
        check_size(r.shape[-1], self.in_dim, "dimension of autocorrelation")
        return super().forward(r)


class CompositeSinusoidalModelCoefficientsToAutocorrelation(BaseOp):
    """[frequencies, intensities] -> autocorrelation by a cosine matmul."""

    def __init__(self, acr_order: int, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = acr_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(acr_order: int) -> Design:
        AutocorrelationToCompositeSinusoidalModelCoefficients._check(
            acr_order)
        return Design(arrays={"ramp": np.arange(acr_order + 1,
                                                dtype=np.float64)})

    @staticmethod
    def _forward(c: torch.Tensor, *, ramp: torch.Tensor) -> torch.Tensor:
        n = c.shape[-1] // 2
        w, m = c[..., :n], c[..., n:]
        return torch.matmul(m[..., None, :],
                            torch.cos(w[..., None] * ramp))[..., 0, :]

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of input")
        return super().forward(c)
