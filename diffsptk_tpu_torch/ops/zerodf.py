"""All-zero (FIR) digital filter with frame-rate coefficients
(counterpart of ``diffsptk_tpu/ops/zerodf.py``).

The direct path: gather the (M+1)-sample history of every output sample
and dot it with per-sample interpolated coefficients.  The frame-blocked
FFT path that the JAX package takes for M+1 > 32 is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from .linear_intpl import linear_interpolate


class AllZeroDigitalFilter(BaseOp):
    """(excitation (..., T), coefficients (..., T/P, M+1)) -> (..., T)."""

    def __init__(self, filter_order: int, frame_period: int, *,
                 ignore_gain: bool = False, zeroth_index: int = 0,
                 mode: str = "direct", dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(filter_order: int, frame_period: int,
               zeroth_index: int) -> None:
        if filter_order < 0:
            raise ValueError("filter_order must be non-negative.")
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if not 0 <= zeroth_index <= filter_order:
            raise ValueError("zeroth_index must be in [0, filter_order].")

    @staticmethod
    def _design(filter_order: int, frame_period: int,
                ignore_gain: bool = False, zeroth_index: int = 0,
                mode: str = "direct") -> Design:
        AllZeroDigitalFilter._check(filter_order, frame_period, zeroth_index)
        padding = (filter_order - zeroth_index, zeroth_index)
        return Design(values={
            "frame_period": frame_period, "ignore_gain": ignore_gain,
            "padding": padding})

    @staticmethod
    def _forward(x: torch.Tensor, b: torch.Tensor, *, frame_period: int,
                 ignore_gain: bool, padding: tuple) -> torch.Tensor:
        check_size(x.shape[-1], b.shape[-2] * frame_period,
                   "sequence length")
        M = b.shape[-1] - 1
        if not ignore_gain and M + 1 > 32:
            raise NotImplementedError(
                "the frame-blocked FFT path of the all-zero filter "
                "(M+1 > 32) is not ported yet")
        xp = F.pad(x, padding)
        frames = xp.unfold(-1, M + 1, 1)                    # (..., T, M+1)
        h = linear_interpolate(torch.flip(b, (-1,)), frame_period)
        if ignore_gain:
            h = h / (h[..., :1] if padding[0] == 0 else h[..., -1:])
        return torch.sum(frames * h, dim=-1)
