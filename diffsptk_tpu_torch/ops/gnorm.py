"""Generalized-cepstrum gain (de)normalization
(counterpart of ``diffsptk_tpu/ops/gnorm.py``).

K = (1 + gamma*c0)^(1/gamma) (exp(c0) at gamma=0); the tail is divided by
(1 + gamma*c0).
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, check_size, filter_values


def get_gamma(gamma: float, c: int | None) -> float:
    """SPTK convention: integer c >= 1 means gamma = -1/c."""
    if c is None or c == 0:
        return gamma
    if c < 1:
        raise ValueError("c must be an integer >= 1.")
    return -1.0 / c


def _check(cep_order: int, gamma: float, c: int | None) -> None:
    if cep_order < 0:
        raise ValueError("cep_order must be non-negative.")
    if 1 < abs(gamma):
        raise ValueError("gamma must be in [-1, 1].")
    if c is not None and c != 0 and c < 1:
        raise ValueError("c must be greater than or equal to 1.")


def gnorm(x: torch.Tensor, gamma: float) -> torch.Tensor:
    x0, x1 = x[..., :1], x[..., 1:]
    if gamma == 0:
        K = torch.exp(x0)
        y = x1
    else:
        z = 1.0 + gamma * x0
        K = torch.pow(z, 1.0 / gamma)
        y = x1 / z
    return torch.cat((K, y), dim=-1)


def ignorm(y: torch.Tensor, gamma: float) -> torch.Tensor:
    K, y1 = y[..., :1], y[..., 1:]
    if gamma == 0:
        x0 = torch.log(K)
        x1 = y1
    else:
        z = torch.pow(K, gamma)
        x0 = (z - 1.0) / gamma
        x1 = y1 * z
    return torch.cat((x0, x1), dim=-1)


class GeneralizedCepstrumGainNormalization(BaseOp):
    """Generalized cepstrum (..., M+1) -> gain-normalized (..., M+1)."""

    def __init__(self, cep_order: int, gamma: float = 0.0,
                 c: int | None = None, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, gamma: float = 0.0,
                c: int | None = None) -> Design:
        _check(cep_order, gamma, c)
        return Design(values={"gamma": get_gamma(gamma, c)})

    @staticmethod
    def _forward(x: torch.Tensor, *, gamma: float) -> torch.Tensor:
        return gnorm(x, gamma)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(x)


class GeneralizedCepstrumInverseGainNormalization(BaseOp):
    """Inverse of :class:`GeneralizedCepstrumGainNormalization`."""

    def __init__(self, cep_order: int, gamma: float = 0.0,
                 c: int | None = None, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, gamma: float = 0.0,
                c: int | None = None) -> Design:
        _check(cep_order, gamma, c)
        return Design(values={"gamma": get_gamma(gamma, c)})

    @staticmethod
    def _forward(y: torch.Tensor, *, gamma: float) -> torch.Tensor:
        return ignorm(y, gamma)

    def forward(self, y):
        check_size(y.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(y)
