"""Linear interpolation: frame rate -> sample rate
(counterpart of ``diffsptk_tpu/ops/linear_intpl.py``).

A static gather of the two bracketing frames plus one lerp.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, filter_values


def linear_interpolate(x: torch.Tensor, upsampling_factor: int) -> torch.Tensor:
    """Upsample (..., N, D) -> (..., N*P, D) linearly along the frame axis
    (replicating the final frame); 1-D inputs are treated as (N,)."""
    P = upsampling_factor
    if P == 1:
        return x
    one_d = x.ndim == 1
    if one_d:
        x = x[:, None]
    N = x.shape[-2]
    xp = torch.cat([x, x[..., -1:, :]], dim=-2)            # (..., N+1, D)
    n = torch.arange(N * P, device=x.device)
    i0 = torch.div(n, P, rounding_mode="floor")
    w = ((n % P).to(x.dtype) / P)[:, None]
    lo = xp[..., i0, :]
    hi = xp[..., i0 + 1, :]
    y = lo * (1 - w) + hi * w
    if one_d:
        y = y[..., 0]
    return y


class LinearInterpolation(BaseOp):
    """Upsample (..., T, D) -> (..., T*P, D) by linear interpolation
    between adjacent frames."""

    def __init__(self, upsampling_factor: int, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(upsampling_factor: int) -> None:
        if upsampling_factor <= 0:
            raise ValueError("upsampling_factor must be positive.")

    @staticmethod
    def _design(upsampling_factor: int) -> Design:
        LinearInterpolation._check(upsampling_factor)
        return Design(values={"upsampling_factor": upsampling_factor})

    @staticmethod
    def _forward(x: torch.Tensor, *, upsampling_factor: int) -> torch.Tensor:
        return linear_interpolate(x, upsampling_factor)
