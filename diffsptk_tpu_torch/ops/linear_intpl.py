"""Linear interpolation: frame rate -> sample rate
(counterpart of ``diffsptk_tpu/ops/linear_intpl.py``).

A static gather of the two bracketing frames plus one lerp.
"""

from __future__ import annotations

import torch


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
