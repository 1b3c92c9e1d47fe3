"""Overlap-add unframing, the WOLA inverse of Frame (counterpart of
``diffsptk_tpu/ops/unframe.py``).

The fold is K = ceil(L/P) shifted adds of contiguous slabs: slab k holds
every frame's samples [k P, (k+1) P) laid end to end, and lands at offset
k P.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from .window import design_window


def overlap_add(y: torch.Tensor, frame_period: int) -> torch.Tensor:
    """Fold frames (..., N, L) into a waveform (..., (N-1)*P + L) by OLA."""
    *batch, N, L = y.shape
    P = frame_period
    K = -(-L // P)  # ceil
    pad_L = K * P
    if pad_L != L:
        y = F.pad(y, (0, pad_L - L))
    T_out = (N - 1) * P + pad_L
    out = y.new_zeros((*batch, T_out))
    for k in range(K):
        slab = y[..., :, k * P:(k + 1) * P].reshape(*batch, N * P)
        out[..., k * P:k * P + N * P] += slab
    return out[..., : (N - 1) * P + L]


class Unframe(BaseOp):
    """Revert framed waveform (..., N, L) to (..., T) with WOLA
    normalization by the folded squared window."""

    def __init__(self, frame_length: int, frame_period: int, *,
                 center: bool = True, window: str = "rectangular",
                 norm: str = "none", symmetric: bool = True,
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = frame_length
        self._setup(self._design(**filter_values(locals(), ("learnable",))),
                    learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _check(frame_length: int, frame_period: int) -> None:
        if frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if frame_length < frame_period:
            raise ValueError("frame_period must be <= frame_length.")

    @staticmethod
    def _design(frame_length: int, frame_period: int, center: bool = True,
                window: str = "rectangular", norm: str = "none",
                symmetric: bool = True) -> Design:
        Unframe._check(frame_length, frame_period)
        w = design_window(frame_length, window, norm, symmetric)
        return Design(
            values={"frame_length": frame_length,
                    "frame_period": frame_period, "center": center},
            arrays={"window": w})

    @staticmethod
    def _forward(y: torch.Tensor, out_length: int | None = None, *,
                 frame_length: int, frame_period: int, center: bool,
                 window: torch.Tensor) -> torch.Tensor:
        if y.ndim < 2:
            raise ValueError("Input must be at least 2D.")
        N = y.shape[-2]
        if out_length is None and center:
            out_length = N * frame_period
        w = torch.broadcast_to(window, y.shape[-2:])
        x = overlap_add(y * window, frame_period)
        d = overlap_add(w * w, frame_period)
        x = x / (d + 1e-16)
        s = frame_length // 2 if center else 0
        e = None if out_length is None else s + out_length
        return x[..., s:e]

    def forward(self, y, out_length=None):
        check_size(y.shape[-1], self.in_dim, "length of waveform")
        return super().forward(y, out_length)
