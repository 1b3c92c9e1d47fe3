"""Real-input FFT and its inverse (counterpart of
``diffsptk_tpu/ops/fftr.py``).

The non-learnable paths are ``torch.fft.rfft`` and ``torch.fft.irfft``
(the JAX package's DFT-as-matmul detour for the TPU is not needed on the
card).  ``learnable=True`` replaces the FFT with an explicit DFT weight
matrix (one matmul) whose entries are trainable.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, filter_values


def _make_formatter(out_format):
    if out_format in (0, "complex"):
        return lambda x: x
    if out_format in (1, "real"):
        return lambda x: x.real
    if out_format in (2, "imaginary"):
        return lambda x: x.imag
    if out_format in (3, "amplitude"):
        return lambda x: torch.abs(x)
    if out_format in (4, "power"):
        return lambda x: torch.square(torch.abs(x))
    raise ValueError(f"out_format {out_format} is not supported.")


class RealValuedFastFourierTransform(BaseOp):
    """rfft of a real signal (..., N) -> (..., L/2+1) with output
    formatting."""

    def __init__(self, fft_length: int, out_format: str | int = "complex",
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())),
                    learnable=learnable is True, dtype=dtype, device=device)

    @staticmethod
    def _check(fft_length: int | None) -> None:
        if fft_length is not None and (fft_length <= 0
                                       or fft_length % 2 == 1):
            raise ValueError("fft_length must be positive even.")

    @staticmethod
    def _design(fft_length: int | None, out_format: str | int = "complex",
                learnable: bool = False) -> Design:
        RealValuedFastFourierTransform._check(fft_length)
        formatter = _make_formatter(out_format)
        arrays = {}
        if learnable:
            if fft_length is None:
                raise ValueError("fft_length must be given when learnable.")
            # Explicit rfft matrix, stored as [Re | Im] so it is real.
            W = np.fft.fft(np.eye(fft_length))[:, : fft_length // 2 + 1]
            arrays["W"] = np.concatenate([W.real, W.imag], axis=-1)
        return Design(
            values={"fft_length": fft_length, "formatter": formatter},
            arrays=arrays)

    @staticmethod
    def _forward(x: torch.Tensor, *, fft_length: int | None, formatter,
                 W: torch.Tensor | None = None) -> torch.Tensor:
        if W is None:
            y = torch.fft.rfft(x, n=fft_length)
        else:
            if fft_length is not None and fft_length != x.shape[-1]:
                x = F.pad(x, (0, fft_length - x.shape[-1]))
            re, im = torch.chunk(torch.matmul(x, W), 2, dim=-1)
            y = torch.complex(re, im)
        return formatter(y)


class RealValuedInverseFastFourierTransform(BaseOp):
    """irfft (..., L/2+1) -> (..., out_length)."""

    def __init__(self, fft_length: int, out_length: int | None = None,
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())),
                    learnable=learnable is True, dtype=dtype, device=device)

    @staticmethod
    def _check(fft_length: int, out_length: int | None) -> None:
        if fft_length <= 0 or fft_length % 2 == 1:
            raise ValueError("fft_length must be positive even.")
        if out_length is not None and (out_length <= 0
                                       or fft_length < out_length):
            raise ValueError("out_length must be in [1, fft_length].")

    @staticmethod
    def _design(fft_length: int, out_length: int | None = None,
                learnable: bool = False) -> Design:
        RealValuedInverseFastFourierTransform._check(fft_length, out_length)
        arrays = {}
        if learnable:
            W = np.fft.ifft(np.eye(fft_length))[: fft_length // 2 + 1,
                                                :out_length]
            W[1:-1] *= 2.0
            arrays["W"] = np.concatenate([W.real, -W.imag], axis=0)
        return Design(values={"out_length": out_length}, arrays=arrays)

    @staticmethod
    def _forward(y: torch.Tensor, *, out_length: int | None,
                 W: torch.Tensor | None = None) -> torch.Tensor:
        if W is None:
            return torch.fft.irfft(y)[..., :out_length]
        yr = torch.cat([y.real, y.imag], dim=-1)
        return torch.matmul(yr, W)
