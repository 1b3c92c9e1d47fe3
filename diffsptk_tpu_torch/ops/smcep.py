"""Second-order all-pass mel-cepstral analysis (counterpart of
``diffsptk_tpu/ops/smcep.py``).

mcep's Newton loop under the (alpha, theta) warp: only the composed warp
plans change, so the forward is MelCepstralAnalysis's, and on the card
its solve is the Newton kernel's one-generator entry.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values
from .freqt2 import (
    SecondOrderAllPassFrequencyTransform,
    SecondOrderAllPassInverseFrequencyTransform,
    warp_function,
)
from .mcep import MelCepstralAnalysis


def design_smcep_cfreqt(in_order: int, out_order: int, alpha: float,
                        theta: float, n_fft: int) -> np.ndarray:
    """Residual warp matrix under the second-order all-pass warp,
    returned so that y = c @ A maps in -> out."""
    theta = theta * np.pi
    omega = np.arange(n_fft) * (2 * np.pi / n_fft)
    ww = warp_function(omega, alpha, theta)
    m2 = np.arange(out_order + 1)
    wwm2 = ww[:, None] * m2[None, :]
    H = np.cos(wwm2) - 1j * np.sin(wwm2)
    A = np.fft.ifft(H, axis=0).real
    L = in_order + 1
    if L >= 2:
        A[1:L] += A[-(L - 1):][::-1]
    return A[:L].copy()


class CoefficientsFrequencyTransform2(BaseOp):
    """theta-warped residual-correlation transform (one matmul)."""

    def __init__(self, in_order: int, out_order: int, alpha: float = 0,
                 theta: float = 0, n_fft: int = 512, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = in_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(in_order: int, out_order: int, alpha: float, theta: float,
               n_fft: int) -> None:
        if in_order < 0 or out_order < 0:
            raise ValueError("order must be non-negative.")
        if 1 <= abs(alpha):
            raise ValueError("alpha must be in (-1, 1).")
        if not 0 <= theta <= 1:
            raise ValueError("theta must be in [0, 1].")
        if n_fft <= 1:
            raise ValueError("n_fft must be greater than 1.")

    @staticmethod
    def _design(in_order: int, out_order: int, alpha: float = 0,
                theta: float = 0, n_fft: int = 512) -> Design:
        CoefficientsFrequencyTransform2._check(in_order, out_order, alpha,
                                               theta, n_fft)
        return Design(arrays={"A": design_smcep_cfreqt(
            in_order, out_order, alpha, theta, n_fft)})

    @staticmethod
    def _forward(c: torch.Tensor, *, A: torch.Tensor) -> torch.Tensor:
        return torch.matmul(c, A)

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class SecondOrderAllPassMelCepstralAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> mel-cepstrum (..., M+1) under the
    (alpha, theta) warp."""

    def __init__(self, *, fft_length: int, cep_order: int, alpha: float = 0,
                 theta: float = 0, n_iter: int = 0,
                 accuracy_factor: int = 4, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, cep_order: int, alpha: float, theta: float,
               n_iter: int, accuracy_factor: int) -> None:
        MelCepstralAnalysis._check(fft_length, cep_order, alpha, n_iter)
        if not 0 <= theta <= 1:
            raise ValueError("theta must be in [0, 1].")
        if accuracy_factor <= 0:
            raise ValueError("accuracy_factor must be positive.")

    @staticmethod
    def _design(fft_length: int, cep_order: int, alpha: float = 0,
                theta: float = 0, n_iter: int = 0,
                accuracy_factor: int = 4) -> Design:
        SecondOrderAllPassMelCepstralAnalysis._check(
            fft_length, cep_order, alpha, theta, n_iter, accuracy_factor)
        n_fft = fft_length * accuracy_factor
        H = fft_length // 2
        M = cep_order
        # MelCepstralAnalysis's composed plans, with the second-order
        # all-pass matrices in place of the freqt ones.
        A_fw = SecondOrderAllPassFrequencyTransform._design(
            in_order=H, out_order=M, alpha=alpha, theta=theta,
            n_fft=n_fft).arrays["A"]                        # (H+1, M+1)
        A_if = SecondOrderAllPassInverseFrequencyTransform._design(
            in_order=M, out_order=H, alpha=alpha, theta=theta,
            n_fft=n_fft).arrays["A"]                        # (M+1, H+1)
        A_rt = design_smcep_cfreqt(H, 2 * M, alpha, theta,
                                   n_fft)                   # (H+1, 2M+1)
        t = np.arange(H + 1)
        ang = 2.0 * np.pi * np.outer(t, t) / fft_length
        C1 = np.cos(ang)
        w = np.full(H + 1, 2.0)
        w[0] = w[H] = 1.0
        Ci = (w[:, None] * np.cos(ang)) / fft_length
        scale = np.ones(H + 1)
        scale[0] = scale[H] = 0.5
        P0 = (Ci * scale[None, :]) @ A_fw
        P1 = A_if @ C1
        P2 = Ci @ A_rt
        # the warp of the unit seed
        alpha_vector = np.ones(1) @ design_smcep_cfreqt(0, M, alpha, theta,
                                                        n_fft)
        return Design(
            values={"fft_length": fft_length, "n_iter": n_iter},
            arrays={"alpha_vector": alpha_vector, "P0": P0, "P1": P1,
                    "P2": P2})

    @staticmethod
    def _forward(*args, **kwargs) -> torch.Tensor:
        return MelCepstralAnalysis._forward(*args, **kwargs)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)
