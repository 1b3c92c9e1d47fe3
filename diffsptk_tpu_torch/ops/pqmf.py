"""Pseudo-QMF cosine-modulated filterbank and fractional-octave-band
analysis (counterpart of ``diffsptk_tpu/ops/pqmf.py``).

The prototype (a Kaiser window and an iterative cutoff search) is designed
on the host in numpy float64.  A bank is applied as one ``conv1d`` of the
(B, C, T) signal with its (K, C, taps) filters, learnable or not, in full
fp32.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import full_precision, place

TAU = 2 * np.pi


def _next_power_of_two(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def make_filter_banks(n_band: int, filter_order: int, mode: str = "analysis",
                      alpha: float = 100, n_iter: int = 100,
                      step_size: float = 1e-2, decay: float = 0.5,
                      eps: float = 1e-6):
    """Cosine-modulated filterbank coefficients (K, M+1) and whether the
    search converged; the prototype lowpass cutoff is tuned by a
    sign-descent iteration so |H(pi/2K)|^2 is 0.5 (Nguyen 1994;
    Cruz-Roldan 2002)."""
    if n_band <= 0:
        raise ValueError("n_band must be positive.")
    if filter_order <= 1:
        raise ValueError("filter_order must be >= 2.")
    if n_iter <= 0:
        raise ValueError("n_iter must be positive.")
    if alpha <= 0:
        raise ValueError("alpha must be positive.")
    if step_size <= 0:
        raise ValueError("step_size must be positive.")
    if decay <= 0:
        raise ValueError("decay must be positive.")
    if eps < 0:
        raise ValueError("eps must be non-negative.")

    def alpha_to_beta(a):
        if a <= 21:
            return 0.0
        if a <= 50:
            return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
        return 0.1102 * (a - 8.7)

    w = np.kaiser(filter_order + 1, alpha_to_beta(alpha))
    x = np.arange(filter_order + 1) - 0.5 * filter_order
    fft_length = _next_power_of_two(filter_order + 1)
    index = fft_length // (4 * n_band)

    omega = np.pi / (2 * n_band)
    best = np.inf
    is_converged = False
    prototype = None
    for _ in range(n_iter):
        with np.errstate(invalid="ignore"):
            h = np.sin(omega * x) / (np.pi * x)
        if filter_order % 2 == 0:
            h[filter_order // 2] = omega / np.pi
        prototype = h * w
        H = np.fft.rfft(prototype, n=fft_length)
        error = np.square(np.abs(H[index])) - 0.5
        abs_error = np.abs(error)
        if abs_error < eps:
            is_converged = True
            break
        if abs_error < best:
            best = abs_error
            omega -= np.sign(error) * step_size
        else:
            step_size *= decay
            omega -= np.sign(error) * step_size

    sign = 1 if mode == "analysis" else -1
    if mode not in ("analysis", "synthesis"):
        raise ValueError("analysis or synthesis is expected.")

    filters = []
    for k in range(n_band):
        a = ((2 * k + 1) * np.pi / (2 * n_band)) * x
        b = (-1) ** k * (np.pi / 4) * sign
        filters.append(2 * prototype * np.cos(a + b))
    return np.asarray(filters), is_converged


def _pad_signal(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Zero-pad left, replicate-pad right (the delay padding)."""
    x = F.pad(x, (left, 0))
    if right > 0:
        x = F.pad(x, (0, right), mode="replicate")
    return x


def _as_3d(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 1:
        return x[None, None, :]
    if x.ndim == 2:
        return x[:, None, :]
    if x.ndim != 3:
        raise ValueError("Input must be 1D, 2D, or 3D tensor.")
    return x


class _FilterBank(nn.Module):
    """A fixed-delay FIR bank: (B, C, T) -> (B, K, T), one conv1d."""

    def _setup_bank(self, filters: np.ndarray, delay: tuple,
                    learnable: bool, dtype, device) -> None:
        t = torch.as_tensor(np.ascontiguousarray(filters))
        if learnable:
            self.filters = nn.Parameter(t)
        else:
            self.register_buffer("filters", t)
        self.delay = delay
        place(self, device, dtype)

    @full_precision
    def _apply_bank(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(_pad_signal(x, *self.delay), self.filters)


def _warn_unconverged(is_converged: bool) -> None:
    if not is_converged:
        warnings.warn("Failed to find PQMF coefficients.")


class PseudoQuadratureMirrorFilterBankAnalysis(_FilterBank):
    """Waveform -> (B, K, T) subband waveforms."""

    def __init__(self, n_band: int, filter_order: int, alpha: float = 100,
                 learnable: bool = False, dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        filters, is_converged = make_filter_banks(
            n_band, filter_order, mode="analysis", alpha=alpha, **kwargs)
        _warn_unconverged(is_converged)
        if filter_order % 2 == 0:
            delay = (filter_order // 2, filter_order // 2)
        else:
            delay = ((filter_order + 1) // 2, (filter_order - 1) // 2)
        self._setup_bank(filters[:, None, ::-1], delay, learnable, dtype,
                         device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_bank(_as_3d(x))


class PseudoQuadratureMirrorFilterBankSynthesis(_FilterBank):
    """(B, K, T) subbands -> (B, 1, T) waveform."""

    def __init__(self, n_band: int, filter_order: int, alpha: float = 100,
                 learnable: bool = False, dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        filters, is_converged = make_filter_banks(
            n_band, filter_order, mode="synthesis", alpha=alpha, **kwargs)
        _warn_unconverged(is_converged)
        if filter_order % 2 == 0:
            delay = (filter_order // 2, filter_order // 2)
        else:
            delay = ((filter_order - 1) // 2, (filter_order + 1) // 2)
        self._setup_bank(filters[None, :, ::-1], delay, learnable, dtype,
                         device)

    def forward(self, y: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
        if y.ndim == 2:
            y = y[None]
        if y.ndim != 3:
            raise ValueError("Input must be 3D tensor.")
        x = self._apply_bank(y)
        return x if keepdim else x[:, 0, :]


class FractionalOctaveBandAnalysis(_FilterBank):
    """1/b-octave linear-phase FIR bank (Antoni 2010): waveform ->
    (B, K, T)."""

    def __init__(self, sample_rate: int, *, f_min: float = 40,
                 f_ref: float = 1000, f_max: float = 8000,
                 filter_order: int = 1000, n_fract: int = 1,
                 overlap: float = 1, dtype=None, device=None) -> None:
        super().__init__()
        if not (0 <= f_min <= f_ref <= f_max <= sample_rate / 2):
            raise ValueError("Invalid frequency range.")
        if filter_order <= 2:
            raise ValueError("filter_order must be greater than 2.")
        if n_fract <= 0:
            raise ValueError("n_fract must be positive.")
        if not 0 <= overlap <= 1:
            raise ValueError("overlap must be in [0, 1].")

        b = n_fract
        G = 10 ** (3 / 10)

        def freq_index(f):
            if b % 2 == 0:
                return int(np.round(2 * b * np.log(f / f_ref)
                                    / np.log(G) - 1) / 2)
            return int(np.round(b * np.log(f / f_ref) / np.log(G)))

        def center_freq(x):
            if b % 2 == 0:
                return f_ref * G ** ((2 * x + 1) / (2 * b))
            return f_ref * G ** (x / b)

        x = np.arange(freq_index(f_min), freq_index(f_max) + 1)
        f_m = center_freq(x)
        f_m = f_m[f_m < sample_rate / 2]
        f_l = f_m * G ** (-1 / (2 * b))
        f_u = f_m * G ** (1 / (2 * b))

        c = (filter_order + 1) / sample_rate
        k_m = np.round(c * f_m).astype(int)
        k_l = np.round(c * f_l).astype(int)
        k_u = np.round(c * f_u).astype(int)
        g = np.round(overlap / 2 * (k_u - k_m)).astype(int)

        magnitude = np.ones((len(f_m), (filter_order + 1) // 2 + 1))
        for j in range(1, len(f_m)):
            i = j - 1
            sl = slice(k_l[j] - g[j], k_l[j] + g[j])
            magnitude[i, sl.stop:] = 0
            magnitude[j, :sl.start] = 0
            if 0 < g[j]:
                z = np.pi / 2 * (np.arange(2 * g[j]) / (2 * g[j]))
                magnitude[i, sl] = np.cos(z) ** 2
                magnitude[j, sl] = np.sin(z) ** 2

        freq = np.fft.rfftfreq(filter_order + 1)
        linear_phase = np.exp(-1j * TAU * filter_order / 2 * freq)
        h = np.fft.irfft(magnitude * linear_phase)
        h = h * np.hanning(h.shape[1])
        # cross-correlate with the unflipped filters, as the JAX package
        self._setup_bank(h[:, None, :],
                         ((filter_order + 1) // 2, (filter_order - 1) // 2),
                         False, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply_bank(_as_3d(x))
