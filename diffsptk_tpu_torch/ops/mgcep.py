"""Mel-generalized cepstral analysis (counterpart of
``diffsptk_tpu/ops/mgcep.py``).

mcep's Newton loop with a b-domain change of variables and the P/Q/R
transform matrices; gamma == 0 delegates to MelCepstralAnalysis.  The
gamma = -1 start and each of the n_iter steps solve, per frame, the
M x M system (Toeplitz(p) + Hankel(q)) x = r with two different
generators: on the card (float32, M <= 33) the two-generator entry of
the Newton kernel (kernels/newton.py), elsewhere the assembled matrix
through utils/linalg.spd_solve.  The JAX package's DFT-as-matmul detour
for the TPU becomes ``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, child, filter_values
from ..kernels.newton import toephank_solve
from ..utils.linalg import hankel, spd_solve, symmetric_toeplitz
from .gnorm import (
    GeneralizedCepstrumGainNormalization,
    GeneralizedCepstrumInverseGainNormalization,
    get_gamma,
)
from .mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)
from .mcep import MelCepstralAnalysis, _use_newton_kernel
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum


def design_mgcep_cfreqt(in_order: int, out_order: int,
                        alpha: float) -> np.ndarray:
    """The b-domain warp matrix: seeded with A[0,0]=1,
    A[1,1:]=alpha^(j-1)*beta."""
    beta = 1.0 - alpha * alpha
    L1, L2 = in_order + 1, out_order + 1
    A = np.zeros((L2, L1))
    A[0, 0] = 1.0
    if L2 > 1 and L1 > 1:
        A[1, 1:] = alpha ** np.arange(L1 - 1) * beta
    for i in range(2, L2):
        for j in range(1, L1):
            A[i, j] = A[i - 1, j - 1] + alpha * (A[i, j - 1] - A[i - 1, j])
    return A.T


def design_ptrans(order: int, alpha: float) -> np.ndarray:
    A = np.eye(order + 1)
    for i in range(order):
        A[i, i + 1] = alpha
    A[0, 0] -= alpha * alpha
    A[0, 1] += alpha
    A[-1, -1] += alpha
    return A.T


def design_qtrans(order: int, alpha: float) -> np.ndarray:
    A = np.eye(order + 1)
    for i in range(1, order + 1):
        A[i, i - 1] = alpha
    A[1, 0] = 0.0
    A[1, 1] += alpha
    return A.T


class MelGeneralizedCepstralAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> mel-generalized cepstrum (..., M+1)."""

    def __init__(self, *, fft_length: int, cep_order: int, alpha: float = 0,
                 gamma: float = 0, c: int | None = None, n_iter: int = 0,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, cep_order: int, alpha: float, gamma: float,
               n_iter: int) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if fft_length < 2 * cep_order:
            raise ValueError("cep_order must be <= fft_length // 2.")
        if 1 <= abs(alpha):
            raise ValueError("alpha must be in (-1, 1).")
        if gamma < -1 or 0 < gamma:
            raise ValueError("gamma must be in [-1, 0].")
        if n_iter < 0:
            raise ValueError("n_iter must be non-negative.")

    @staticmethod
    def _design(fft_length: int, cep_order: int, alpha: float = 0,
                gamma: float = 0, c: int | None = None,
                n_iter: int = 0) -> Design:
        gamma = get_gamma(gamma, c)
        MelGeneralizedCepstralAnalysis._check(fft_length, cep_order, alpha,
                                              gamma, n_iter)
        values = {"fft_length": fft_length, "gamma": gamma,
                  "n_iter": n_iter}
        if gamma == 0:
            return Design(values=values, layers={"mcep": child(
                MelCepstralAnalysis, fft_length=fft_length,
                cep_order=cep_order, alpha=alpha, n_iter=n_iter)})
        M, L = cep_order, fft_length
        layers = {
            "ign": child(GeneralizedCepstrumInverseGainNormalization,
                         cep_order=M, gamma=-1),
            "b2mc_": child(MLSADigitalFilterCoefficientsToMelCepstrum,
                           cep_order=M, alpha=alpha),
            "g2g": child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                         in_order=M, out_order=M, in_gamma=-1,
                         out_gamma=gamma),
            "mc2b_": child(MelCepstrumToMLSADigitalFilterCoefficients,
                           cep_order=M, alpha=alpha),
            "gn": child(GeneralizedCepstrumGainNormalization, cep_order=M,
                        gamma=gamma),
            "gn2": child(GeneralizedCepstrumInverseGainNormalization,
                         cep_order=M, gamma=gamma),
        }
        arrays = {
            "cfreqt": design_mgcep_cfreqt(M, L - 1, -alpha),
            "pfreqt": design_mgcep_cfreqt(L - 1, 2 * M, alpha),
            "rfreqt": design_mgcep_cfreqt(L - 1, M, alpha),
            "ptrans": design_ptrans(2 * M, alpha),
            "qtrans": design_qtrans(2 * M, alpha),
        }
        return Design(values=values, layers=layers, arrays=arrays)

    @staticmethod
    def _newton(x: torch.Tensor, gamma: float, b1: torch.Tensor, *,
                fft_length: int, cfreqt, pfreqt, rfreqt, ptrans, qtrans):
        """One Newton step at ``gamma``: (b0, b1) from b1."""
        M = b1.shape[-1]
        L = fft_length
        if gamma == -1:
            p = torch.fft.irfft(x) @ pfreqt
            q = p
            r = p[..., :M + 1]
        else:
            b = F.pad(b1, (1, 0))
            C = torch.fft.rfft(b @ cfreqt, n=L)
            X = 1 + gamma * C.real
            Y = gamma * C.imag
            XX, YY = X * X, Y * Y
            D = XX + YY
            E = torch.pow(D, -1 / gamma)
            pw = x * E / D
            qw = pw / D
            p = torch.fft.irfft(pw) @ pfreqt
            q = torch.fft.irfft(torch.complex(qw * (XX - YY), qw * 2 * X * Y),
                                n=L) @ pfreqt
            r = torch.fft.irfft(torch.complex(pw * X, pw * Y), n=L) @ rfreqt
        p = p @ ptrans
        q = q @ qtrans

        def epsilon(b):
            return r[..., 0] + gamma * torch.sum(r[..., 1:] * b, dim=-1)

        if gamma != -1:
            eps = epsilon(b1)
        pt = p[..., :M]
        qt = q[..., 2:] * (1 + gamma)
        rt = r[..., 1:]
        if _use_newton_kernel(qt, M):
            gradient = toephank_solve(pt, qt, rt)
        else:
            gradient = spd_solve(symmetric_toeplitz(pt) + hankel(qt), rt)
        b1 = b1 + gradient
        if gamma == -1:
            eps = epsilon(b1)
        return torch.sqrt(eps)[..., None], b1

    @staticmethod
    def _forward(x: torch.Tensor, *, fft_length: int, gamma: float,
                 n_iter: int, mcep=None, ign=None, b2mc_=None, g2g=None,
                 mc2b_=None, gn=None, gn2=None, **plans) -> torch.Tensor:
        if gamma == 0:
            return mcep(x)
        M = plans["cfreqt"].shape[0] - 1
        step = MelGeneralizedCepstralAnalysis._newton
        b1 = x.new_zeros(x.shape[:-1] + (M,))
        b0, b1 = step(x, -1, b1, fft_length=fft_length, **plans)
        if gamma != -1:
            b = torch.cat((b0, b1), dim=-1)
            b = gn(mc2b_(g2g(b2mc_(ign(b)))))
            b1 = b[..., 1:]
            for _ in range(n_iter):
                b0, b1 = step(x, gamma, b1, fft_length=fft_length, **plans)
        return b2mc_(gn2(torch.cat((b0, b1), dim=-1)))

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)
