"""Second-order all-pass frequency transform and its inverse
(counterpart of ``diffsptk_tpu/ops/freqt2.py``).

The (alpha, theta) warp function is sampled on an n_fft grid,
inverse-FFT'd and folded into a warp matrix on the host in numpy;
applying it is one matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values


def warp_function(omega: np.ndarray, alpha: float,
                  theta: float) -> np.ndarray:
    x = omega - theta
    y = omega + theta
    return (omega
            + np.arctan2(alpha * np.sin(x), 1 - alpha * np.cos(x))
            + np.arctan2(alpha * np.sin(y), 1 - alpha * np.cos(y)))


def warp_derivative(omega: np.ndarray, alpha: float,
                    theta: float) -> np.ndarray:
    x = omega - theta
    y = omega + theta
    a1 = alpha
    a2 = 2 * alpha
    aa = alpha * alpha
    return (1
            + (a1 * np.cos(x) - aa) / (1 - a2 * np.cos(x) + aa)
            + (a1 * np.cos(y) - aa) / (1 - a2 * np.cos(y) + aa))


def _check_args(in_order: int, out_order: int, alpha: float,
                theta: float) -> None:
    if in_order < 0:
        raise ValueError("in_order must be non-negative.")
    if out_order < 0:
        raise ValueError("out_order must be non-negative.")
    if 1 <= abs(alpha):
        raise ValueError("alpha must be in (-1, 1).")
    if not 0 <= theta <= 1:
        raise ValueError("theta must be in [0, 1].")


def design_freqt2(in_order: int, out_order: int, alpha: float, theta: float,
                  n_fft: int) -> np.ndarray:
    theta = theta * np.pi
    omega = np.arange(n_fft) * (2 * np.pi / n_fft)
    ww = warp_function(omega, alpha, theta)
    dw = warp_derivative(omega, alpha, theta)
    m2 = np.arange(out_order + 1)
    wwm2 = ww[:, None] * m2[None, :]
    H = np.cos(wwm2) * dw[:, None] - 1j * np.sin(wwm2) * dw[:, None]
    A = np.fft.ifft(H, axis=0).real
    L = in_order + 1
    if L >= 2:
        A[1:L] += A[-(L - 1):][::-1]
    A = A[:L].copy()
    A[1:, 0] /= 2
    A[0, 1:] *= 2
    return A


def design_ifreqt2(in_order: int, out_order: int, alpha: float, theta: float,
                   n_fft: int) -> np.ndarray:
    theta = theta * np.pi
    omega = np.arange(n_fft) * (2 * np.pi / n_fft)
    ww = warp_function(omega, alpha, theta)
    m1 = np.arange(-in_order, in_order + 1)
    wwm1 = ww[:, None] * m1[None, :]
    H = np.cos(wwm1) - 1j * np.sin(wwm1)
    A = np.fft.ifft(H, axis=0).real
    L = out_order + 1
    M = in_order + 1
    A[:L, M:] += A[:L, : M - 1][:, ::-1]
    A = A[:L, M - 1:].copy()
    A[1:, 0] *= 2
    A[0, 1:] /= 2
    return A.T


class _SecondOrderAllPassWarp(BaseOp):
    """Shared: (..., M1+1) -> (..., M2+1) by one warp matrix A."""

    def __init__(self, in_order: int, out_order: int, alpha: float = 0,
                 theta: float = 0, n_fft: int = 512, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = in_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(in_order: int, out_order: int, alpha: float,
               theta: float) -> None:
        _check_args(in_order, out_order, alpha, theta)

    @staticmethod
    def _forward(c: torch.Tensor, *, A: torch.Tensor) -> torch.Tensor:
        return torch.matmul(c, A)

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class SecondOrderAllPassFrequencyTransform(_SecondOrderAllPassWarp):
    """Cepstrum -> second-order all-pass warped cepstrum (freqt2)."""

    @staticmethod
    def _design(in_order: int, out_order: int, alpha: float = 0,
                theta: float = 0, n_fft: int = 512) -> Design:
        _check_args(in_order, out_order, alpha, theta)
        return Design(arrays={"A": design_freqt2(in_order, out_order, alpha,
                                                 theta, n_fft)})


class SecondOrderAllPassInverseFrequencyTransform(_SecondOrderAllPassWarp):
    """Inverse of :class:`SecondOrderAllPassFrequencyTransform`."""

    @staticmethod
    def _design(in_order: int, out_order: int, alpha: float = 0,
                theta: float = 0, n_fft: int = 512) -> Design:
        _check_args(in_order, out_order, alpha, theta)
        return Design(arrays={"A": design_ifreqt2(in_order, out_order, alpha,
                                                  theta, n_fft)})
