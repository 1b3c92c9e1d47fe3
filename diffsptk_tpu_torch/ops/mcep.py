"""Mel-cepstral analysis (counterpart of ``diffsptk_tpu/ops/mcep.py``).

Per Newton iteration: two composed transform matmuls and one batched
(M+1)x(M+1) Toeplitz+Hankel solve per frame.  On the card (float32,
M+1 <= 33) the iteration runs lane-major, frames on the last axis, and
the solve is the hand-written Newton kernel (kernels/newton.py); the
(batch, n, n) Hessian never exists.  Elsewhere the Hessian is assembled
and solved by the masked Cholesky of utils/linalg.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, filter_values
from ..kernels.newton import MAX_ORDER, newton_solve_t
from ..utils.linalg import hankel, spd_solve, symmetric_toeplitz
from .freqt import FrequencyTransform, design_freqt


def _use_newton_kernel(x: torch.Tensor, n: int) -> bool:
    """The kernel takes float32 systems of order <= 33 on the card, at
    any batch.

    The JAX package also asks for a batch of at least 2,048 systems
    (diffsptk_tpu/ops/mcep.py:35-36), below which XLA's batched Cholesky
    served the TPU better than a Pallas launch.  The port keeps no batch
    gate, by choice: on the H100 the kernel is faster than the plain path
    at small batches too (one launch of one warp per system against a
    Cholesky of many small batched torch calls; chip_smoke.py's [K1]
    times both at 64 systems), and it stays within the 2e-4 bar of
    float64 there (tests/test_torch_gpu.py)."""
    return x.is_cuda and x.dtype == torch.float32 and n <= MAX_ORDER


def design_coef_freqt(in_order: int, out_order: int,
                      alpha: float) -> np.ndarray:
    """The residual-correlation warp matrix used inside the Newton step;
    same recurrence as freqt but seeded with (-alpha)^i in column 0."""
    L1, L2 = in_order + 1, out_order + 1
    A = np.zeros((L2, L1))
    A[:, 0] = (-alpha) ** np.arange(L2)
    for i in range(1, L2):
        for j in range(1, L1):
            A[i, j] = A[i - 1, j - 1] + alpha * (A[i, j - 1] - A[i - 1, j])
    return A.T


class CoefficientsFrequencyTransform(BaseOp):
    """Frequency transform on plain cepstra, as used inside the mcep
    Newton loop."""

    def __init__(self, in_order: int, out_order: int,
                 alpha: float = 0, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = in_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(in_order: int, out_order: int, alpha: float) -> None:
        FrequencyTransform._check(in_order, out_order, alpha)

    @staticmethod
    def _design(in_order: int, out_order: int, alpha: float = 0) -> Design:
        CoefficientsFrequencyTransform._check(in_order, out_order, alpha)
        return Design(arrays={"A": design_coef_freqt(in_order, out_order,
                                                     alpha)})

    @staticmethod
    def _forward(c: torch.Tensor, *, A: torch.Tensor) -> torch.Tensor:
        return torch.matmul(c, A)

    def forward(self, c):
        check_size(c.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(c)


class MelCepstralAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> mel-cepstrum (..., M+1)."""

    def __init__(self, *, fft_length: int, cep_order: int,
                 alpha: float = 0, n_iter: int = 0, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, cep_order: int, alpha: float,
               n_iter: int) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")
        if fft_length < 2 * cep_order:
            raise ValueError("cep_order must be <= fft_length // 2.")
        if 1 <= abs(alpha):
            raise ValueError("alpha must be in (-1, 1).")
        if n_iter < 0:
            raise ValueError("n_iter must be non-negative.")

    @staticmethod
    def _design(fft_length: int, cep_order: int, alpha: float = 0,
                n_iter: int = 0) -> Design:
        MelCepstralAnalysis._check(fft_length, cep_order, alpha, n_iter)
        H = fft_length // 2
        M = cep_order
        # The Newton iteration's two transform chains each compose into
        # one matmul (host-side, float64):
        #   D  = Re(rfft(ifreqt(mc), L))      -> mc @ P1,  P1 (M+1, H+1)
        #   rt = rfreqt(irfft_real(d, L))     -> d  @ P2,  P2 (H+1, 2M+1)
        t = np.arange(H + 1)
        k = np.arange(H + 1)
        ang = 2.0 * np.pi * np.outer(t, k) / fft_length
        C1 = np.cos(ang)                                    # (H+1, H+1)
        w = np.full(H + 1, 2.0)
        w[0] = 1.0
        w[H] = 1.0
        Ci = (w[:, None] * np.cos(ang)) / fft_length        # (H+1, H+1)
        A_if = design_freqt(cep_order, H, -alpha)           # (M+1, H+1)
        A_rt = design_coef_freqt(H, 2 * M, alpha)           # (H+1, 2M+1)
        P1 = A_if @ C1
        P2 = Ci @ A_rt
        # The seed chain irfft(log X)[..., :H+1] * scale -> freqt is one
        # composed matmul too.
        scale = np.ones(H + 1)
        scale[0] = 0.5
        scale[H] = 0.5
        A_seed = design_freqt(H, cep_order, alpha)          # (H+1, M+1)
        P0 = (Ci * scale[None, :]) @ A_seed
        alpha_vector = (-alpha) ** np.arange(cep_order + 1)
        return Design(
            values={"fft_length": fft_length, "n_iter": n_iter},
            arrays={"alpha_vector": alpha_vector, "P0": P0, "P1": P1,
                    "P2": P2})

    @staticmethod
    def _forward(x: torch.Tensor, *, fft_length: int, n_iter: int,
                 P0: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor,
                 alpha_vector: torch.Tensor) -> torch.Tensor:
        M = alpha_vector.shape[-1] - 1
        H = fft_length // 2
        n = M + 1

        log_x = torch.log(x)
        mc = torch.matmul(log_x, P0)
        if n_iter == 0:
            return mc

        if _use_newton_kernel(x, n):
            # Lane-major: frames on the last axis, so the solve reads
            # each generator row as consecutive addresses.
            batch = x.shape[:-1]
            mc_t = mc.reshape(-1, n).T                      # (n, B)
            lx_t = log_x.reshape(-1, H + 1).T               # (H+1, B)
            P1_t = P1.T                                     # (H+1, M+1)
            P2_t = P2.T                                     # (2M+1, H+1)
            av = alpha_vector[:, None]
            for _ in range(n_iter):
                D = torch.matmul(P1_t, mc_t)                # (H+1, B)
                d = torch.exp(lx_t - D - D)
                rt_t = torch.matmul(P2_t, d)                # (2M+1, B)
                ra_t = rt_t[:n] - av
                mc_t = mc_t + newton_solve_t(rt_t, ra_t)
            return mc_t.T.reshape(batch + (n,))

        for _ in range(n_iter):
            D = torch.matmul(mc, P1)
            d = torch.exp(log_x - D - D)
            rt = torch.matmul(d, P2)
            r = rt[..., :n]
            ra = r - alpha_vector
            R = symmetric_toeplitz(r)
            Q = hankel(rt)
            mc = mc + spd_solve(R + Q, ra)
        return mc

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)
