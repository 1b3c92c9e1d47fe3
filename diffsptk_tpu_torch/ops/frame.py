"""Waveform framing (counterpart of ``diffsptk_tpu/ops/frame.py``).

Padding plus one ``unfold`` view: frame n covers [n*P, n*P + L).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, filter_values

_PAD_MODES = ("constant", "reflect", "replicate", "circular")


class Frame(BaseOp):
    """Split a waveform (..., T) into frames (..., T/P, L).

    Parameters: frame_length L, frame_period P, center (pad both sides so
    frames are centered), zmean (per-frame mean removal), mode (padding).
    """

    def __init__(self, frame_length: int, frame_period: int, *,
                 center: bool = True, zmean: bool = False,
                 mode: str = "constant", dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(frame_length: int, frame_period: int, mode: str) -> None:
        if frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if mode not in _PAD_MODES:
            raise ValueError(f"mode {mode} is not supported.")

    @staticmethod
    def _design(frame_length: int, frame_period: int, center: bool = True,
                zmean: bool = False, mode: str = "constant") -> Design:
        Frame._check(frame_length, frame_period, mode)
        return Design(values={
            "frame_length": frame_length,
            "frame_period": frame_period,
            "center": center,
            "zmean": zmean,
            "mode": mode,
        })

    @staticmethod
    def _forward(x: torch.Tensor, *, frame_length: int, frame_period: int,
                 center: bool, zmean: bool, mode: str) -> torch.Tensor:
        L, P = frame_length, frame_period
        pad = (L // 2, (L - 1) // 2) if center else (0, L - 1)
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), pad, mode=mode)
        x = x.reshape(shape[:-1] + (x.shape[-1],))
        y = x.unfold(-1, L, P)
        if zmean:
            y = y - torch.mean(y, dim=-1, keepdim=True)
        return y
