"""Window functions (counterpart of ``diffsptk_tpu/ops/window.py``).

All SPTK window types are designed host-side in numpy float64 and applied
as one multiply plus zero padding.  SPTK integer aliases are accepted.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values


def _cosine_sum(L: int, coeffs, periodic: bool) -> np.ndarray:
    size = L if periodic else L - 1
    n = np.arange(L)
    w = np.zeros(L)
    for k, c in enumerate(coeffs):
        w = w + c * np.cos(2.0 * np.pi * k * n / max(size, 1))
    return w


def design_window(length: int, window: str | int = "blackman",
                  norm: str | int = "power",
                  symmetric: bool = True) -> np.ndarray:
    """Host-side window design in float64; returns the window vector."""
    L = length
    periodic = not symmetric
    n = np.arange(L)
    if window in (0, "blackman"):
        w = _cosine_sum(L, [0.42, -0.50, 0.08], periodic)
    elif window in (1, "hamming"):
        w = _cosine_sum(L, [0.54, -0.46], periodic)
    elif window in (2, "hanning"):
        w = _cosine_sum(L, [0.5, -0.5], periodic)
    elif window in (3, "bartlett"):
        size = L if periodic else L - 1
        w = 1.0 - np.abs(2.0 * n / max(size, 1) - 1.0)
    elif window in (4, "trapezoidal"):
        size = L if periodic else L - 1
        w = np.minimum(2.0 * (1.0 - np.abs(2.0 * n / max(size, 1) - 1.0)),
                       1.0)
    elif window in (5, "rectangular"):
        w = np.ones(L)
    elif window in (6, "nuttall"):
        w = _cosine_sum(L, [0.355768, -0.487396, 0.144232, -0.012604],
                        periodic)
    elif window == "povey":
        w = _cosine_sum(L, [0.5, -0.5], periodic) ** 0.85
    elif window == "sine":
        size = L + 1 if periodic else L
        w = np.sin(np.pi * (n + 0.5) / size)
    elif window == "vorbis":
        size = L + 1 if periodic else L
        s = np.sin(np.pi * (n + 0.5) / size)
        w = np.sin(0.5 * np.pi * s * s)
    elif window == "kbd":
        if periodic:
            raise ValueError("periodic is not supported for kbd window.")
        seed = np.kaiser(L // 2 + 1, 12.0)
        csum = np.cumsum(seed)
        half = np.sqrt(csum[:-1] / csum[-1])
        w = np.concatenate([half, half[::-1]])
    else:
        raise ValueError(f"window {window} is not supported.")

    if norm in (0, "none"):
        pass
    elif norm in (1, "power"):
        w = w / np.sqrt(np.sum(w * w))
    elif norm in (2, "magnitude"):
        w = w / np.sum(w)
    else:
        raise ValueError(f"norm {norm} is not supported.")
    return w


class Window(BaseOp):
    """Apply a window to framed input (..., L1) -> (..., L2) with zero-pad
    to ``out_length``."""

    def __init__(self, in_length: int, out_length: int | None = None, *,
                 window: str | int = "blackman", norm: str | int = "power",
                 symmetric: bool = True, learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = in_length
        self._setup(self._design(**filter_values(locals(), ("learnable",))),
                    learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _check(in_length: int, out_length: int | None) -> None:
        if in_length <= 0:
            raise ValueError("in_length must be positive.")
        if out_length is not None and out_length <= 0:
            raise ValueError("out_length must be positive.")

    @staticmethod
    def _design(in_length: int, out_length: int | None = None,
                window: str | int = "blackman", norm: str | int = "power",
                symmetric: bool = True) -> Design:
        Window._check(in_length, out_length)
        w = design_window(in_length, window, norm, symmetric)
        return Design(values={"out_length": out_length},
                      arrays={"window": w})

    @staticmethod
    def _forward(x: torch.Tensor, *, out_length: int | None,
                 window: torch.Tensor) -> torch.Tensor:
        y = x * window
        if out_length is not None and out_length != x.shape[-1]:
            y = F.pad(y, (0, out_length - x.shape[-1]))
        return y

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "input length")
        return super().forward(x)
