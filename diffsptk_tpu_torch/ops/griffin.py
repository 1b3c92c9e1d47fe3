"""Accelerated Griffin-Lim phase reconstruction (Nenov et al. 2023
momentum scheme; counterpart of ``diffsptk_tpu/ops/griffin.py``).

A fixed number of STFT/ISTFT rounds.  The random initial phase is JAX's
``jax.random.uniform(PRNGKey(seed), shape, dtype)``, drawn by the port's
copy of JAX's generator (utils/prng.py), so both packages start from the
same phase at float32 and at float64.
"""

from __future__ import annotations

import math

import torch

from ..core import BaseOp, Design, child, filter_values
from ..utils import prng
from .stft import (
    InverseShortTimeFourierTransform,
    ShortTimeFourierTransform,
)


class GriffinLim(BaseOp):
    """Power spectrum (..., T/P, N/2+1) -> waveform (..., T)."""

    def __init__(self, frame_length: int, frame_period: int,
                 fft_length: int, *, center: bool = True,
                 mode: str = "constant", window: str = "blackman",
                 norm: str = "power", symmetric: bool = True,
                 n_iter: int = 100, alpha: float = 0.99, beta: float = 0.99,
                 gamma: float = 1.1, init_phase: str = "random",
                 seed: int = 0, verbose: bool = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(n_iter: int, alpha: float, beta: float, gamma: float) -> None:
        if n_iter < 0:
            raise ValueError("n_iter must be non-negative.")
        if alpha < 0 or beta < 0 or gamma < 0:
            raise ValueError("alpha/beta/gamma must be non-negative.")

    @staticmethod
    def _design(frame_length: int, frame_period: int, fft_length: int,
                center: bool = True, mode: str = "constant",
                window: str = "blackman", norm: str = "power",
                symmetric: bool = True, n_iter: int = 100,
                alpha: float = 0.99, beta: float = 0.99, gamma: float = 1.1,
                init_phase: str = "random", seed: int = 0,
                verbose: bool = False) -> Design:
        GriffinLim._check(n_iter, alpha, beta, gamma)

        if init_phase == "zeros":
            phase_generator = torch.zeros_like
        elif init_phase == "random":
            def phase_generator(s):
                key = prng.PRNGKey(seed, device=s.device)
                return 2 * math.pi * prng.uniform(key, s.shape, s.dtype)
        else:
            raise ValueError(f"init_phase: {init_phase} is not supported.")

        stft = child(ShortTimeFourierTransform, frame_length=frame_length,
                     frame_period=frame_period, fft_length=fft_length,
                     center=center, zmean=False, mode=mode, window=window,
                     norm=norm, symmetric=symmetric, eps=0,
                     relative_floor=None, out_format="complex")
        istft = child(InverseShortTimeFourierTransform,
                      frame_length=frame_length, frame_period=frame_period,
                      fft_length=fft_length, center=center, window=window,
                      norm=norm, symmetric=symmetric)
        return Design(
            values={"n_iter": n_iter, "alpha": alpha, "beta": beta,
                    "gamma": gamma, "phase_generator": phase_generator},
            layers={"stft": stft, "istft": istft})

    @staticmethod
    def _forward(y: torch.Tensor, out_length: int | None = None, *,
                 n_iter: int, alpha: float, beta: float, gamma: float,
                 phase_generator, stft, istft) -> torch.Tensor:
        eps = 1e-16
        s = torch.sqrt(y + eps)
        angle = torch.exp(1j * phase_generator(s))

        t_prev = d_prev = None
        for n in range(n_iter):
            t = stft(istft(s * angle, out_length))
            t = t[..., : s.shape[-2], :]
            if n == 0:
                c = d = t
            else:
                t = (1 - gamma) * d_prev + gamma * t
                diff = t - t_prev
                c = t + alpha * diff
                d = t + beta * diff
            angle = c / (torch.abs(c) + eps)
            t_prev, d_prev = t, d

        return istft(s * angle, out_length)
