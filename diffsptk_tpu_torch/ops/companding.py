"""Companding and uniform quantization (counterpart of
``diffsptk_tpu/ops/companding.py``).

Elementwise ops.  The quantizers pass gradients straight through their
floor and round (the forward is fn(x), the gradient the identity's).
"""

from __future__ import annotations

import math

import torch

from ..core import BaseOp, Design, filter_values


def _ste(fn, x):
    """Straight-through: forward fn(x), gradient identity."""
    return x + (fn(x) - x).detach()


class ALawCompression(BaseOp):
    """A-law compression (..., T) -> (..., T)."""

    def __init__(self, abs_max: float = 1.0, a: float = 87.6, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, a: float) -> None:
        if abs_max < 0:
            raise ValueError("abs_max must be non-negative.")
        if a < 1:
            raise ValueError("a must be greater than or equal to 1.")

    @staticmethod
    def _design(abs_max: float = 1.0, a: float = 87.6) -> Design:
        ALawCompression._check(abs_max, a)
        return Design(values={"abs_max": abs_max, "a": a,
                              "c": abs_max / (1 + math.log(a))})

    @staticmethod
    def _forward(x, *, abs_max, a, c):
        x_abs = torch.abs(x) / abs_max
        x1 = a * x_abs
        x2 = 1 + torch.log(torch.clamp(x1, min=1e-38))
        return c * torch.sign(x) * torch.where(x_abs < 1 / a, x1, x2)


class ALawExpansion(BaseOp):
    """Inverse of :class:`ALawCompression`."""

    def __init__(self, abs_max: float = 1.0, a: float = 87.6, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, a: float) -> None:
        ALawCompression._check(abs_max, a)

    @staticmethod
    def _design(abs_max: float = 1.0, a: float = 87.6) -> Design:
        ALawCompression._check(abs_max, a)
        return Design(values={"abs_max": abs_max, "c": abs_max / a,
                              "z": 1 + math.log(a)})

    @staticmethod
    def _forward(y, *, abs_max, c, z):
        y_abs = torch.abs(y) / abs_max
        y1 = z * y_abs
        y2 = torch.exp(y1 - 1)
        return c * torch.sign(y) * torch.where(y_abs < 1 / z, y1, y2)


class MuLawCompression(BaseOp):
    """mu-law companding y = sign(x) V log(1 + mu|x|/V) / log(1 + mu)."""

    def __init__(self, abs_max: float = 1.0, mu: int = 255, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, mu: int) -> None:
        if abs_max < 0:
            raise ValueError("abs_max must be non-negative.")
        if mu < 1:
            raise ValueError("mu must be greater than or equal to 1.")

    @staticmethod
    def _design(abs_max: float = 1.0, mu: int = 255) -> Design:
        MuLawCompression._check(abs_max, mu)
        return Design(values={"abs_max": abs_max, "mu": mu,
                              "c": abs_max / math.log1p(mu)})

    @staticmethod
    def _forward(x, *, abs_max, mu, c):
        x_abs = torch.abs(x) / abs_max
        return c * torch.sign(x) * torch.log1p(mu * x_abs)


class MuLawExpansion(BaseOp):
    """Inverse of :class:`MuLawCompression`."""

    def __init__(self, abs_max: float = 1.0, mu: int = 255, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, mu: int) -> None:
        MuLawCompression._check(abs_max, mu)

    @staticmethod
    def _design(abs_max: float = 1.0, mu: int = 255) -> Design:
        MuLawCompression._check(abs_max, mu)
        return Design(values={"abs_max": abs_max, "mu": mu,
                              "c": abs_max / mu})

    @staticmethod
    def _forward(y, *, abs_max, mu, c):
        y_abs = torch.abs(y) / abs_max
        return c * torch.sign(y) * (torch.pow(1 + mu, y_abs) - 1)


class UniformQuantization(BaseOp):
    """Mid-rise / mid-tread quantizer with straight-through gradients."""

    def __init__(self, abs_max: float = 1.0, n_bit: int = 8,
                 quantizer: str | int = "mid-rise", dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, n_bit: int) -> None:
        if abs_max < 0:
            raise ValueError("abs_max must be non-negative.")
        if n_bit <= 0:
            raise ValueError("n_bit must be positive.")

    @staticmethod
    def _design(abs_max: float = 1.0, n_bit: int = 8,
                quantizer: str | int = "mid-rise") -> Design:
        UniformQuantization._check(abs_max, n_bit)
        if quantizer in (0, "mid-rise"):
            level = 1 << n_bit
            func = lambda x: _ste(torch.floor, x + level // 2)  # noqa: E731
        elif quantizer in (1, "mid-tread"):
            level = (1 << n_bit) - 1
            func = lambda x: _ste(torch.round,  # noqa: E731
                                  x + (level - 1) // 2)
        else:
            raise ValueError(f"quantizer {quantizer} is not supported.")
        return Design(values={"abs_max": abs_max, "level": level,
                              "func": func})

    @staticmethod
    def _forward(x, *, abs_max, level, func):
        y = func(x * (level / (2 * abs_max)))
        return torch.clamp(y, 0, level - 1)


class InverseUniformQuantization(BaseOp):
    """Quantization indices -> values (mid-rise / mid-tread)."""

    def __init__(self, abs_max: float = 1.0, n_bit: int = 8,
                 quantizer: str | int = "mid-rise", dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(abs_max: float, n_bit: int) -> None:
        UniformQuantization._check(abs_max, n_bit)

    @staticmethod
    def _design(abs_max: float = 1.0, n_bit: int = 8,
                quantizer: str | int = "mid-rise") -> Design:
        UniformQuantization._check(abs_max, n_bit)
        if quantizer in (0, "mid-rise"):
            level = 1 << n_bit
            func = lambda y: y - (level // 2 - 0.5)  # noqa: E731
        elif quantizer in (1, "mid-tread"):
            level = (1 << n_bit) - 1
            func = lambda y: y - (level // 2)  # noqa: E731
        else:
            raise ValueError(f"quantizer {quantizer} is not supported.")
        return Design(values={"abs_max": abs_max, "level": level,
                              "func": func})

    @staticmethod
    def _forward(y, *, abs_max, level, func):
        x = func(y) * (2 * abs_max / level)
        return torch.clamp(x, -abs_max, abs_max)
