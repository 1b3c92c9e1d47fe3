"""Gammatone filterbank analysis and synthesis (Hohmann 2002; Herzke
2007; counterpart of ``diffsptk_tpu/ops/gammatone.py``).

Analysis applies each band's order-gamma complex all-pole
(1 - a z^-1)^-gamma as gamma one-pole complex recurrences
(``first_order_recurrence``): on the card a float32 input runs complex64
through the scan kernel (kernels/scan.py), gamma launches a call.  The
synthesis design (delays, phase factors, the gain fixpoint) runs on the
host in numpy complex128, a copy of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseNonFunctionalOp, Design, check_size
from ..kernels.recurrence import first_order_recurrence

TAU = 2 * np.pi
_ERB_L = 24.7
_ERB_Q = 9.265


def _hz_to_erb(hz):
    return _ERB_Q * np.log1p(hz / (_ERB_L * _ERB_Q))


def _erb_to_hz(erb):
    return (_ERB_L * _ERB_Q) * np.expm1(erb / _ERB_Q)


def design_gammatone(sample_rate: int, f_min: float = 70,
                     f_ref: float = 1000, f_max: float = 6700,
                     filter_order: int = 4, bandwidth_factor: float = 1,
                     density: float = 1, exact: bool = False):
    """The design on the host: a dict of each band's complex pole
    ``a_tilde``, gain ``K``, FIR numerator ``b`` (or None), ``gamma`` and
    the ``center_frequencies``."""
    if not (0 <= f_min <= f_ref <= f_max <= sample_rate / 2):
        raise ValueError("Invalid frequency range.")
    if filter_order <= 0:
        raise ValueError("filter_order must be positive.")
    if bandwidth_factor <= 0:
        raise ValueError("bandwidth_factor must be positive.")
    if density <= 0:
        raise ValueError("density must be positive.")

    erb_min = _hz_to_erb(f_min)
    erb_ref = _hz_to_erb(f_ref)
    erb_max = _hz_to_erb(f_max)
    erb_begin = erb_ref - np.floor((erb_ref - erb_min) * density) / density
    cf_erb = np.arange(erb_begin, erb_max + 1e-6, 1 / density)
    cf_hz = _erb_to_hz(cf_erb)

    erb_audio = (_ERB_L + cf_hz / _ERB_Q) * bandwidth_factor
    gamma = filter_order
    a_gamma = (np.pi * math.factorial(2 * gamma - 2)
               * 2.0 ** -(2 * gamma - 2) / math.factorial(gamma - 1) ** 2)
    bw = erb_audio / a_gamma
    lam = np.exp(-TAU * bw / sample_rate)
    beta = TAU * cf_hz / sample_rate
    z = np.exp(1j * beta)
    a_tilde = lam * z

    # The exact mode's FIR numerator (Eulerian-number coefficients).
    b = None
    if exact and filter_order >= 2:
        ramp = np.arange(1, filter_order + 1)
        c = np.zeros(filter_order)
        c[0] = 1
        for i in range(2, filter_order):
            t1 = c * ramp
            t2 = -np.roll(t1, 1)
            t3 = i * np.roll(c, 1)
            c = t1 + t2 + t3
        b = np.zeros((len(a_tilde), filter_order), dtype=np.complex128)
        b[:, 1:] = c[:-1] * a_tilde[:, None] ** ramp[:-1]

    # The gain that makes the response 0 dB at the center frequency.
    if exact:
        K = 2 / np.abs(np.diag(_H_np(z, a_tilde, gamma, b, None)))
    else:
        K = 2 * (1 - np.abs(a_tilde)) ** gamma
    K = np.where((beta == 0) | (beta == np.pi), 0.5 * K, K)
    return dict(a_tilde=a_tilde, K=K, b=b, gamma=gamma,
                center_frequencies=cf_hz)


def _H_np(z, a_tilde, gamma, b, K):
    """Frequency response at complex z: (C, K_bands)."""
    if b is not None:
        # denominator coefficients by the binomial expansion
        a = np.zeros((len(a_tilde), gamma), dtype=np.complex128)
        for i in range(1, gamma + 1):
            a[:, i - 1] = math.comb(gamma, i) * (-a_tilde) ** i
        ramp = np.arange(gamma + 1)
        zs = z[:, None] ** -ramp
        numer = zs[:, :-1] @ b.T
        denom = 1 + zs[:, 1:] @ a.T
        F_ = numer / denom
    else:
        F_ = (1 + (-a_tilde)[None, :] / z[:, None]) ** -gamma
    if K is not None:
        F_ = K[None, :] * F_
    return F_


def _impulse_response_np(design, length):
    """The bands' impulse responses on the host, (K_bands, length)."""
    from scipy.signal import lfilter
    a_tilde, K, b, gamma = (design["a_tilde"], design["K"], design["b"],
                            design["gamma"])
    x = np.zeros(length)
    x[0] = 1.0
    out = []
    for kk in range(len(a_tilde)):
        y = K[kk] * x.astype(np.complex128)
        for _ in range(gamma):
            y = lfilter([1.0], [1.0, -a_tilde[kk]], y)
        if b is not None:
            y = lfilter(b[kk], [1.0], y)
        out.append(y)
    return np.stack(out)


class GammatoneFilterBankAnalysis(BaseNonFunctionalOp):
    """Waveform (T,), (B, T) or (B, 1, T) -> complex subbands (B, K, T)."""

    def __init__(self, sample_rate: int, *, f_min: float = 70,
                 f_ref: float = 1000, f_max: float = 6700,
                 filter_order: int = 4, bandwidth_factor: float = 1,
                 density: float = 1, exact: bool = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        d = design_gammatone(sample_rate, f_min, f_ref, f_max, filter_order,
                             bandwidth_factor, density, exact)
        arrays = {"a_tilde": d["a_tilde"], "K": d["K"]}
        if d["b"] is not None:
            arrays["b"] = d["b"]
        self._setup(Design(values={"gamma": d["gamma"], "exact": exact},
                           arrays=arrays), dtype=dtype, device=device)
        self.center_frequencies = d["center_frequencies"]

    @staticmethod
    def _forward(x: torch.Tensor, *, gamma: int, exact: bool,
                 a_tilde: torch.Tensor, K: torch.Tensor,
                 b: torch.Tensor | None = None) -> torch.Tensor:
        if x.ndim == 1:
            x = x[None]
        elif x.ndim == 3:
            x = x[:, 0, :]
        if x.ndim != 2:
            raise ValueError("Input must be 1D, 2D, or 3D tensor.")
        y = K[None, :, None] * x[:, None, :].to(a_tilde.dtype)
        pole = a_tilde[None, :, None]
        for _ in range(gamma):
            y = first_order_recurrence(y, pole)
        if exact and b is not None:
            acc = b[None, :, 0:1] * y
            shifted = y
            for k in range(1, b.shape[-1]):
                shifted = torch.cat((torch.zeros_like(shifted[..., :1]),
                                     shifted[..., :-1]), dim=-1)
                acc = acc + b[None, :, k:k + 1] * shifted
            y = acc
        return y


class GammatoneFilterBankSynthesis(BaseNonFunctionalOp):
    """Complex subbands (B, K, T) -> waveform: each band delayed, its phase
    adjusted, then a gain-weighted sum."""

    def __init__(self, sample_rate: int, *, desired_delay: float = 4,
                 f_min: float = 70, f_ref: float = 1000,
                 f_max: float = 6700, filter_order: int = 4,
                 bandwidth_factor: float = 1, density: float = 1,
                 exact: bool = False, n_iter: int = 100,
                 eps: float = 1e-8, dtype=None, device=None) -> None:
        super().__init__()
        delay = round(desired_delay * sample_rate / 1000)
        if delay < 1:
            raise ValueError("Please increase the desired delay.")
        if n_iter <= 0:
            raise ValueError("The number of iterations must be positive.")
        if eps < 0:
            raise ValueError("The tolerance must be non-negative.")

        d = design_gammatone(sample_rate, f_min, f_ref, f_max, filter_order,
                             bandwidth_factor, density, exact)
        ir = _impulse_response_np(d, delay + 2)
        max_idx = np.argmax(np.abs(ir[:, :-1]), axis=-1)
        rows = np.arange(ir.shape[0])
        slopes = ir[rows, max_idx + 1] - ir[rows, max_idx - 1]
        slopes = slopes / np.abs(slopes)
        phase_factors = 1j / slopes
        delay_samples = delay - max_idx

        cf = d["center_frequencies"]
        z = np.exp(1j * TAU * cf / sample_rate)
        Hp = _H_np(z, d["a_tilde"], d["gamma"], d["b"], d["K"])
        Hn = _H_np(np.conj(z), d["a_tilde"], d["gamma"], d["b"], d["K"])
        pos = Hp * phase_factors[None, :] * (z[:, None]
                                             ** -delay_samples[None, :])
        neg = Hn * phase_factors[None, :] * (np.conj(z)[:, None]
                                             ** -delay_samples[None, :])
        combined = 0.5 * (pos + np.conj(neg))
        gains = np.ones(combined.shape[-1], dtype=np.complex128)
        for _ in range(n_iter):
            prev = gains
            gains = gains / np.abs(combined @ gains)
            if np.mean(np.abs(prev - gains)) < eps:
                break

        self._setup(Design(
            values={"delay": delay, "max_delay": int(delay_samples.max())},
            arrays={"phase_factors": phase_factors[:, None],
                    "gains": gains.real[:, None],
                    "delay_samples": delay_samples[:, None]}),
            dtype=dtype, device=device)

    @staticmethod
    def _forward(y: torch.Tensor, keepdim: bool = True,
                 compensate_delay: bool = True, *, delay: int,
                 max_delay: int, phase_factors: torch.Tensor,
                 gains: torch.Tensor,
                 delay_samples: torch.Tensor) -> torch.Tensor:
        if y.ndim == 2:
            y = y[None]
        if y.ndim != 3:
            raise ValueError("Input must be 3D tensor.")
        B, K, T = y.shape
        check_size(K, phase_factors.shape[0], "number of filters")

        phi = phase_factors
        y_prime = y.real * phi.real - y.imag * phi.imag
        padded = F.pad(y_prime, (max_delay, 0))
        index = (torch.arange(T, device=y.device)[None, :] + max_delay
                 - delay_samples.to(torch.int64))             # (K, T)
        delayed = torch.gather(padded, -1, index.expand(B, K, T))

        x = torch.sum(delayed * gains, dim=1, keepdim=keepdim)
        if compensate_delay:
            x = F.pad(x[..., delay:], (0, delay))
        return x
