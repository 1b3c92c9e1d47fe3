"""MDCT/MDST, their inverses and the Hilbert transform (counterpart of
``diffsptk_tpu/ops/mdct.py``).

50 %-overlap frames -> window -> oddly-stacked basis matmul; the inverse
overlap-adds through Unframe.  Padding one frame period at the end of the
analysis gives perfect reconstruction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, child, filter_values
from .frame import Frame
from .stft import _normalize_learnable
from .unframe import Unframe
from .window import Window


def design_mdt(length: int, window: str, transform: str = "cosine"):
    """Oddly-stacked (I)MDCT/(I)MDST basis (length, length/2)."""
    if length < 2 or length % 2 == 1:
        raise ValueError("length must be at least 2 and even.")
    L = length // 2
    n = np.arange(length) + 0.5
    k = (np.pi / L) * n[:L]
    n = n + L / 2
    z = 2.0 / L
    if window != "rectangular":
        z *= 2.0
    z **= 0.5
    if transform == "cosine":
        return z * np.cos(k[None, :] * n[:, None])
    if transform == "sine":
        return z * np.sin(k[None, :] * n[:, None])
    raise ValueError(f"transform must be 'cosine' or 'sine', got "
                     f"'{transform}'.")


class ModifiedDiscreteTransform(BaseOp):
    """(..., L) -> (..., L/2) oddly-stacked transform."""

    def __init__(self, length: int, window: str, transform: str = "cosine",
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = length
        self._setup(self._design(length, window, transform),
                    learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _design(length: int, window: str,
                transform: str = "cosine") -> Design:
        return Design(arrays={"W": design_mdt(length, window, transform)})

    @staticmethod
    def _forward(x: torch.Tensor, *, W: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, W)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of input")
        return super().forward(x)


class InverseModifiedDiscreteTransform(BaseOp):
    """(..., L/2) -> (..., L)."""

    def __init__(self, length: int, window: str, transform: str = "cosine",
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = length // 2
        self._setup(self._design(length, window, transform),
                    learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _design(length: int, window: str,
                transform: str = "cosine") -> Design:
        return Design(arrays={"W": design_mdt(length, window, transform).T})

    @staticmethod
    def _forward(y: torch.Tensor, *, W: torch.Tensor) -> torch.Tensor:
        return torch.matmul(y, W)

    def forward(self, y):
        check_size(y.shape[-1], self.in_dim, "dimension of input")
        return super().forward(y)


class ModifiedDiscreteCosineTransform(BaseOp):
    """Waveform (..., T) -> MDCT coefficients (..., 2T/L, L/2)."""

    def __init__(self, frame_length: int, window: str = "sine",
                 transform: str = "cosine",
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(frame_length: int, window: str = "sine",
                transform: str = "cosine",
                learnable: bool | list = False) -> Design:
        learn = _normalize_learnable(learnable)
        frame_period = frame_length // 2
        frame = child(Frame, frame_length=frame_length,
                      frame_period=frame_period)
        window_ = child(Window, in_length=frame_length, out_length=None,
                        window=window, norm="none", symmetric=True,
                        learnable="window" in learn)
        mdt = child(ModifiedDiscreteTransform, length=frame_length,
                    window=window, transform=transform,
                    learnable="basis" in learn)
        return Design(values={"frame_period": frame_period},
                      layers={"frame": frame, "window": window_,
                              "mdt": mdt})

    @staticmethod
    def _forward(x: torch.Tensor, *, frame_period: int, frame, window,
                 mdt) -> torch.Tensor:
        x = F.pad(x, (0, frame_period))       # for perfect reconstruction
        return mdt(window(frame(x)))


class InverseModifiedDiscreteCosineTransform(BaseOp):
    """MDCT coefficients -> waveform via overlap-add."""

    def __init__(self, frame_length: int, window: str = "sine",
                 transform: str = "cosine",
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(frame_length: int, window: str = "sine",
                transform: str = "cosine",
                learnable: bool | list = False) -> Design:
        learn = _normalize_learnable(learnable)
        frame_period = frame_length // 2
        imdt = child(InverseModifiedDiscreteTransform, length=frame_length,
                     window=window, transform=transform,
                     learnable="basis" in learn)
        window_ = child(Window, in_length=frame_length, out_length=None,
                        window=window, norm="none", symmetric=True,
                        learnable="window" in learn)
        unframe = child(Unframe, frame_length=frame_length,
                        frame_period=frame_period)
        return Design(values={"frame_period": frame_period},
                      layers={"imdt": imdt, "window": window_,
                              "unframe": unframe})

    @staticmethod
    def _forward(y: torch.Tensor, out_length: int | None = None, *,
                 frame_period: int, imdt, window, unframe) -> torch.Tensor:
        x = unframe(window(imdt(y)), out_length)
        if out_length is None:
            x = x[..., :-frame_period]
        return x


class ModifiedDiscreteSineTransform(ModifiedDiscreteCosineTransform):
    """MDST: the MDCT with the sine basis."""

    def __init__(self, frame_length: int, window: str = "sine",
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__(frame_length, window, transform="sine",
                         learnable=learnable, dtype=dtype, device=device)


class InverseModifiedDiscreteSineTransform(
        InverseModifiedDiscreteCosineTransform):
    """IMDST: the IMDCT with the sine basis."""

    def __init__(self, frame_length: int, window: str = "sine",
                 learnable: bool | list = False, dtype=None,
                 device=None) -> None:
        super().__init__(frame_length, window, transform="sine",
                         learnable=learnable, dtype=dtype, device=device)


class HilbertTransform(BaseOp):
    """Analytic signal via an FFT mask: (..., L) -> complex (..., L) whose
    imaginary part is the Hilbert transform."""

    def __init__(self, fft_length: int, dim: int = -1, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(fft_length: int, dim: int = -1) -> Design:
        if fft_length <= 0:
            raise ValueError("fft_length must be positive.")
        h = np.zeros(fft_length)
        center = (fft_length + 1) // 2
        h[0] = 1.0
        h[1:center] = 2.0
        if fft_length % 2 == 0:
            h[center] = 1.0
        return Design(values={"dim": dim}, arrays={"h": h})

    @staticmethod
    def _forward(x: torch.Tensor, *, dim: int,
                 h: torch.Tensor) -> torch.Tensor:
        L = h.shape[0]
        shape = [1] * x.ndim
        shape[dim] = L
        X = torch.fft.fft(x, n=L, dim=dim)
        return torch.fft.ifft(X * h.reshape(shape), n=L, dim=dim)
