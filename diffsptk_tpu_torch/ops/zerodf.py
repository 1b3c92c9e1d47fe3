"""All-zero (FIR) digital filter with frame-rate coefficients
(counterpart of ``diffsptk_tpu/ops/zerodf.py``).

Two paths, chosen by the filter's length as in the JAX package:

* direct -- gather the (M+1)-sample history of every output sample and
  dot it with per-sample interpolated coefficients (M+1 <= 32, or
  ``ignore_gain``);
* fft -- frame-blocked: since the coefficients interpolate linearly
  between frames, y(t) in frame n is (1-l) conv(x, b_n) + l conv(x,
  b_{n+1}), two fixed-kernel convolutions over a 2P-sample span; one
  batched rfft of the (2P+M)-sample contexts, a product with the
  per-frame coefficient spectra and one irfft.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from .linear_intpl import linear_interpolate


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def zerodf_fft(x: torch.Tensor, b: torch.Tensor, frame_period: int,
               advance: int = 0, b_spec: torch.Tensor | None = None,
               nfft: int | None = None) -> torch.Tensor:
    """Frame-blocked FFT evaluation of the time-varying FIR
    y[t] = sum_k btilde[t, k] x[t - k + advance], where btilde linearly
    interpolates the frame coefficients (the last frame replicated).

    ``b_spec`` optionally supplies rfft(b, nfft), so a cascade that reuses
    the same coefficients pays for their transform once.
    """
    P = frame_period
    M = b.shape[-1] - 1
    N = b.shape[-2]
    L = 2 * P + M
    if nfft is None:
        nfft = _next_pow2(L + 1)
    xp = F.pad(x, (P + M - advance, advance))
    ctx = xp.unfold(-1, L, P)[..., :N, :]                # (..., N, 2P+M)
    if b_spec is None:
        b_spec = torch.fft.rfft(b, n=nfft)
    U = torch.fft.irfft(torch.fft.rfft(ctx, n=nfft) * b_spec,
                        n=nfft)[..., M:M + 2 * P]
    lo = U[..., P:]                                      # b_n on frame n
    hi = torch.cat([U[..., 1:, :P], U[..., -1:, P:]], dim=-2)
    lam = torch.arange(P, dtype=x.dtype, device=x.device) / P
    y = lo * (1 - lam) + hi * lam
    return y.reshape(x.shape)


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
            # The per-sample gain normalization of ignore_gain does not
            # split over the frame interpolation, so it stays direct.
            return zerodf_fft(x, b, frame_period, advance=padding[1])
        xp = F.pad(x, padding)
        frames = xp.unfold(-1, M + 1, 1)                    # (..., T, M+1)
        h = linear_interpolate(torch.flip(b, (-1,)), frame_period)
        if ignore_gain:
            h = h / (h[..., :1] if padding[0] == 0 else h[..., -1:])
        return torch.sum(frames * h, dim=-1)
