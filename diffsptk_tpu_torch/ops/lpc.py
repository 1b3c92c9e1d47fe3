"""LPC analysis = levdur(acorr(x)) (counterpart of
``diffsptk_tpu/ops/lpc.py``)."""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, child
from .acorr import Autocorrelation
from .levdur import LevinsonDurbin, default_eps


class LinearPredictiveCodingAnalysis(BaseOp):
    """Framed waveform (..., L) -> gain + LPC (..., M+1)."""

    def __init__(self, frame_length: int, lpc_order: int,
                 eps: float | None = None, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(frame_length, lpc_order,
                                 default_eps(eps, dtype)),
                    dtype=dtype, device=device)

    @staticmethod
    def _design(frame_length: int, lpc_order: int, eps: float) -> Design:
        acorr = child(Autocorrelation, frame_length=frame_length,
                      acr_order=lpc_order)
        levdur = child(LevinsonDurbin, lpc_order=lpc_order, eps=eps)
        return Design(layers={"acorr": acorr, "levdur": levdur})

    @staticmethod
    def _forward(x: torch.Tensor, *, acorr, levdur) -> torch.Tensor:
        return levdur(acorr(x))
