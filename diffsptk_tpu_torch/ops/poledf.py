"""All-pole digital filter with frame-rate coefficients (counterpart of
``diffsptk_tpu/ops/poledf.py``).

Coefficients are linearly interpolated to sample rate, the gain multiplies
the excitation, and the time-varying recurrence runs in
kernels/recurrence.py: the first-order scan kernel at order 1, the exact
block-parallel form in plain torch above it.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, check_size, filter_values
from ..kernels.recurrence import chunked_sample_wise_lpc, sample_wise_lpc
from .linear_intpl import linear_interpolate


class AllPoleDigitalFilter(BaseOp):
    """(excitation (..., T), LPC (..., T/P, M+1)) -> waveform (..., T)."""

    def __init__(self, filter_order: int, frame_period: int, *,
                 ignore_gain: bool = False,
                 chunk_length: int | None = None,
                 warmup_length: int | None = None, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(filter_order: int, frame_period: int) -> None:
        if filter_order < 0:
            raise ValueError("filter_order must be non-negative.")
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")

    @staticmethod
    def _design(filter_order: int, frame_period: int,
                ignore_gain: bool = False, chunk_length: int | None = None,
                warmup_length: int | None = None) -> Design:
        AllPoleDigitalFilter._check(filter_order, frame_period)
        if chunk_length is not None and warmup_length is None:
            warmup_length = 8 * (filter_order + 1)
        return Design(values={
            "frame_period": frame_period, "ignore_gain": ignore_gain,
            "chunk_length": chunk_length, "warmup_length": warmup_length})

    @staticmethod
    def _forward(x: torch.Tensor, a: torch.Tensor, *, frame_period: int,
                 ignore_gain: bool, chunk_length: int | None,
                 warmup_length: int | None) -> torch.Tensor:
        check_size(x.shape[-1], a.shape[-2] * frame_period,
                   "sequence length")
        a = linear_interpolate(a, frame_period)       # (..., T, M+1)
        K, a1 = a[..., :1], a[..., 1:]
        if not ignore_gain:
            x = K[..., 0] * x
        if chunk_length is not None:
            return chunked_sample_wise_lpc(x, a1, chunk_length,
                                           warmup_length)
        return sample_wise_lpc(x, a1)
