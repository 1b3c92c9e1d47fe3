"""STFT and its inverse (counterpart of ``diffsptk_tpu/ops/stft.py``).

STFT is literally ``spec(window(frame(x)))``, composed at design time;
ISTFT is ``unframe(ifftr(y))``, a weighted overlap-add.
"""

from __future__ import annotations

import torch

from ..core import BaseOp, Design, child, filter_values
from .fftr import (
    RealValuedFastFourierTransform,
    RealValuedInverseFastFourierTransform,
)
from .frame import Frame
from .spec import Spectrum
from .unframe import Unframe
from .window import Window

LEARNABLES = ("basis", "window")


def _normalize_learnable(learnable):
    if learnable is True:
        return LEARNABLES
    if learnable is False:
        return ()
    if any(k not in LEARNABLES for k in learnable):
        raise ValueError("An unsupported key is found in learnable.")
    return tuple(learnable)


class ShortTimeFourierTransform(BaseOp):
    """(..., T) -> (..., T/P, L/2+1) spectrogram."""

    def __init__(self, frame_length: int, frame_period: int, fft_length: int,
                 *, center: bool = True, zmean: bool = False,
                 mode: str = "constant", window: str = "blackman",
                 norm: str = "power", symmetric: bool = True,
                 eps: float = 1e-9, relative_floor: float | None = None,
                 out_format: str = "power",
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(learnable) -> None:
        _normalize_learnable(learnable)

    @staticmethod
    def _design(frame_length: int, frame_period: int, fft_length: int,
                center: bool = True, zmean: bool = False,
                mode: str = "constant", window: str = "blackman",
                norm: str = "power", symmetric: bool = True,
                eps: float = 1e-9, relative_floor: float | None = None,
                out_format: str = "power",
                learnable: bool | list = False) -> Design:
        learn = _normalize_learnable(learnable)
        frame = child(Frame, frame_length=frame_length,
                      frame_period=frame_period, center=center, zmean=zmean,
                      mode=mode)
        window_ = child(Window, in_length=frame_length,
                        out_length=fft_length, window=window, norm=norm,
                        symmetric=symmetric, learnable="window" in learn)
        if out_format == "complex":
            spec = child(RealValuedFastFourierTransform,
                         fft_length=fft_length, out_format="complex",
                         learnable="basis" in learn)
        else:
            spec = child(Spectrum, fft_length=fft_length, eps=eps,
                         relative_floor=relative_floor,
                         out_format=out_format, learnable="basis" in learn)
        return Design(layers={"frame": frame, "window": window_,
                              "spec": spec})

    @staticmethod
    def _forward(x: torch.Tensor, *, frame, window, spec) -> torch.Tensor:
        return spec(window(frame(x)))


class InverseShortTimeFourierTransform(BaseOp):
    """(..., T/P, L/2+1) complex -> (..., T) waveform via WOLA."""

    def __init__(self, frame_length: int, frame_period: int, fft_length: int,
                 *, center: bool = True, window: str = "blackman",
                 norm: str = "power", symmetric: bool = True,
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(frame_length: int, frame_period: int, fft_length: int,
                center: bool = True, window: str = "blackman",
                norm: str = "power", symmetric: bool = True,
                learnable: bool | list = False) -> Design:
        learn = _normalize_learnable(learnable)
        ifftr = child(RealValuedInverseFastFourierTransform,
                      fft_length=fft_length, out_length=frame_length,
                      learnable="basis" in learn)
        unframe = child(Unframe, frame_length=frame_length,
                        frame_period=frame_period, center=center,
                        window=window, norm=norm, symmetric=symmetric,
                        learnable="window" in learn)
        return Design(layers={"ifftr": ifftr, "unframe": unframe})

    @staticmethod
    def _forward(y: torch.Tensor, out_length: int | None = None, *, ifftr,
                 unframe) -> torch.Tensor:
        return unframe(ifftr(y), out_length)
