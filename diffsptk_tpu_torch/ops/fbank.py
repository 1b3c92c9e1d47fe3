"""Mel-filterbank analysis family: FBANK, IFBANK, MFCC and PLP
(counterpart of ``diffsptk_tpu/ops/fbank.py``).

The triangular (or ERB-shaped) filterbank is designed on the host on one
of the auditory scales (a copy of the JAX package's design); it is
applied as one matmul over the spectrum axis.  PLP's Levinson-Durbin is
the port's ``LevinsonDurbin``: on the card, float32 orders 13..64 at 2048
frames or more take the SPD solve kernel (kernels/solve.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, child, filter_values
from ..utils.scales import auditory_to_hz, hz_to_auditory
from .dct import DiscreteCosineTransform
from .levdur import LevinsonDurbin
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum


def design_fbank(fft_length: int, n_channel: int, sample_rate: int,
                 f_min: float = 0.0, f_max: float | None = None,
                 scale: str = "htk",
                 erb_factor: float | None = None) -> np.ndarray:
    """(fft_length//2+1, n_channel) filterbank weights, float64."""
    if f_max is None:
        f_max = sample_rate / 2
    weights = np.zeros((fft_length // 2 + 1, n_channel))

    if erb_factor is None:
        mel_min = hz_to_auditory(f_min, scale)
        mel_max = hz_to_auditory(f_max, scale)
        lower_bin = max(1, int(f_min / sample_rate * fft_length + 1.5))
        upper_bin = min(fft_length // 2,
                        int(f_max / sample_rate * fft_length + 0.5))
        seed = np.arange(1, n_channel + 2)
        center = (mel_max - mel_min) / (n_channel + 1) * seed + mel_min
        bins = np.arange(lower_bin, upper_bin)
        mel = hz_to_auditory(sample_rate * bins / fft_length, scale)
        diff = center - np.insert(center[:-1], 0, mel_min)
        for i, k in enumerate(bins):
            m = int(np.argmax(0 < (mel[i] <= center)))
            w = (center[max(0, m)] - mel[i]) / diff[max(0, m)]
            if 0 < m:
                weights[k, m - 1] = w
            if m < n_channel:
                weights[k, m] = 1 - w
    else:
        a = erb_factor * 6.23e-6
        b = erb_factor * 93.39e-3
        c = erb_factor * 28.52

        def center_frequency(f, at_first):
            sign = 1 if at_first else -1
            a_hat = sign * 0.5 * (1 / (700 + f))
            b_hat = sign * 700 / (700 + f)
            c_hat = -sign * 0.5 * f * (1 + 700 / (700 + f))
            b_bar = (b - b_hat) / (a - a_hat)
            c_bar = (c - c_hat) / (a - a_hat)
            return 0.5 * (-b_bar + np.sqrt(b_bar ** 2 - 4 * c_bar))

        fc_1 = center_frequency(f_min, True)
        fc_C = center_frequency(f_max, False)
        zc = np.linspace(hz_to_auditory(fc_1, scale),
                         hz_to_auditory(fc_C, scale), n_channel)
        fc = auditory_to_hz(zc, scale)
        erb = a * fc ** 2 + b * fc + c
        fl = -(700 + erb) + np.sqrt(erb ** 2 + (700 + fc) ** 2)
        fh = fl + 2 * erb
        f = np.linspace(0, sample_rate / 2, fft_length // 2 + 1)
        for m, (low, cen, high) in enumerate(zip(fl, fc, fh)):
            mask = (low <= f) & (f < cen)
            weights[mask, m] = (f[mask] - low) / (cen - low)
            mask = (cen <= f) & (f <= high)
            weights[mask, m] = (high - f[mask]) / (high - cen)
    return weights


def _check_fbank(fft_length, n_channel, sample_rate, f_min, f_max, floor,
                 gamma, erb_factor) -> None:
    if fft_length <= 1:
        raise ValueError("fft_length must be greater than 1.")
    if n_channel <= 0:
        raise ValueError("n_channel must be positive.")
    if sample_rate <= 0:
        raise ValueError("sample_rate must be positive.")
    if f_min < 0 or sample_rate / 2 <= f_min:
        raise ValueError("Invalid f_min.")
    if f_max is not None and not (f_min < f_max <= sample_rate / 2):
        raise ValueError("Invalid f_min and f_max.")
    if floor <= 0:
        raise ValueError("floor must be positive.")
    if 1 < abs(gamma):
        raise ValueError("gamma must be in [-1, 1].")
    if erb_factor is not None and erb_factor <= 0:
        raise ValueError("erb_factor must be positive.")


def _cepstral_formatter(out_format):
    """MFCC's and PLP's output: y, then c0 and/or the energy E."""
    if out_format in (0, "y"):
        return lambda y, c, E: y
    if out_format in (1, "yE"):
        return lambda y, c, E: torch.cat((y, E), dim=-1)
    if out_format in (2, "yc"):
        return lambda y, c, E: torch.cat((y, c), dim=-1)
    if out_format in (3, "ycE"):
        return lambda y, c, E: torch.cat((y, c, E), dim=-1)
    raise ValueError(f"out_format {out_format} is not supported.")


def _lifter(order: int, lifter: int, zeroth: float) -> np.ndarray:
    ramp = np.arange(order + 1)
    lift = 1 + (lifter / 2) * np.sin((np.pi / lifter) * ramp)
    lift[0] = zeroth
    return lift


class MelFilterBankAnalysis(BaseOp):
    """Power spectrum (..., L/2+1) -> filterbank output (..., C) (+
    energy)."""

    def __init__(self, *, fft_length: int, n_channel: int, sample_rate: int,
                 f_min: float = 0, f_max: float | None = None,
                 floor: float = 1e-5, gamma: float = 0, scale: str = "htk",
                 erb_factor: float | None = None, use_power: bool = False,
                 out_format: str | int = "y", learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(
            self._design(**filter_values(locals(), ("learnable",))),
            learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _check(*args) -> None:
        _check_fbank(*args)

    @staticmethod
    def _design(fft_length: int, n_channel: int, sample_rate: int,
                f_min: float = 0, f_max: float | None = None,
                floor: float = 1e-5, gamma: float = 0, scale: str = "htk",
                erb_factor: float | None = None, use_power: bool = False,
                out_format: str | int = "y") -> Design:
        _check_fbank(fft_length, n_channel, sample_rate, f_min, f_max,
                     floor, gamma, erb_factor)
        if out_format in (0, "y"):
            formatter = lambda y, E: y  # noqa: E731
        elif out_format in (1, "yE"):
            formatter = lambda y, E: torch.cat((y, E), dim=-1)  # noqa: E731
        elif out_format in (2, "y,E"):
            formatter = lambda y, E: (y, E)  # noqa: E731
        else:
            raise ValueError(f"out_format {out_format} is not supported.")
        H = design_fbank(fft_length, n_channel, sample_rate, f_min, f_max,
                         scale, erb_factor)
        return Design(
            values={"floor": floor, "gamma": gamma, "use_power": use_power,
                    "formatter": formatter},
            arrays={"H": H})

    @staticmethod
    def _forward(x: torch.Tensor, *, floor: float, gamma: float,
                 use_power: bool, formatter, H: torch.Tensor):
        y = x if use_power else torch.sqrt(x)
        y = torch.matmul(y, H)
        y = torch.clamp(y, min=floor)
        y = torch.log(y) if gamma == 0 else (torch.pow(y, gamma) - 1) / gamma
        E = torch.sum(2 * x[..., 1:-1], dim=-1) + x[..., 0] + x[..., -1]
        E = torch.log(E / (2 * (x.shape[-1] - 1)))[..., None]
        return formatter(y, E)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)


class InverseMelFilterBankAnalysis(BaseOp):
    """Filterbank output -> power spectrum through the pseudo-inverse."""

    def __init__(self, *, n_channel: int, fft_length: int, sample_rate: int,
                 f_min: float = 0, f_max: float | None = None,
                 gamma: float = 0, scale: str = "htk",
                 erb_factor: float | None = None, use_power: bool = False,
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = n_channel
        self._setup(
            self._design(**filter_values(locals(), ("learnable",))),
            learnable=["H"] if learnable else False, dtype=dtype,
            device=device)

    @staticmethod
    def _design(n_channel: int, fft_length: int, sample_rate: int,
                f_min: float = 0, f_max: float | None = None,
                gamma: float = 0, scale: str = "htk",
                erb_factor: float | None = None,
                use_power: bool = False) -> Design:
        H = design_fbank(fft_length, n_channel, sample_rate, f_min, f_max,
                         scale, erb_factor)
        return Design(values={"gamma": gamma, "use_power": use_power},
                      arrays={"H": np.linalg.pinv(H)})

    @staticmethod
    def _forward(y: torch.Tensor, *, gamma: float, use_power: bool,
                 H: torch.Tensor) -> torch.Tensor:
        x = torch.exp(y) if gamma == 0 else torch.pow(gamma * y + 1,
                                                      1 / gamma)
        x = torch.matmul(x, H)
        return x if use_power else torch.square(x)

    def forward(self, y):
        check_size(y.shape[-1], self.in_dim, "dimension of filterbank output")
        return super().forward(y)


class MelFrequencyCepstralCoefficientsAnalysis(BaseOp):
    """Power spectrum -> MFCC (..., M) with liftering and c0 / energy
    options."""

    def __init__(self, *, fft_length: int, mfcc_order: int, n_channel: int,
                 sample_rate: int, lifter: int = 1, f_min: float = 0,
                 f_max: float | None = None, floor: float = 1e-5,
                 gamma: float = 0, scale: str = "htk",
                 erb_factor: float | None = None,
                 out_format: str | int = "y", learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(mfcc_order: int, n_channel: int, lifter: int) -> None:
        if mfcc_order < 0:
            raise ValueError("mfcc_order must be non-negative.")
        if n_channel <= mfcc_order:
            raise ValueError("mfcc_order must be less than n_channel.")
        if lifter < 0:
            raise ValueError("lifter must be non-negative.")

    @staticmethod
    def _design(fft_length: int, mfcc_order: int, n_channel: int,
                sample_rate: int, lifter: int = 1, f_min: float = 0,
                f_max: float | None = None, floor: float = 1e-5,
                gamma: float = 0, scale: str = "htk",
                erb_factor: float | None = None,
                out_format: str | int = "y",
                learnable: bool = False) -> Design:
        MelFrequencyCepstralCoefficientsAnalysis._check(mfcc_order,
                                                        n_channel, lifter)
        fbank = child(MelFilterBankAnalysis, fft_length=fft_length,
                      n_channel=n_channel, sample_rate=sample_rate,
                      f_min=f_min, f_max=f_max, floor=floor, gamma=gamma,
                      scale=scale, erb_factor=erb_factor, use_power=False,
                      out_format="y,E", learnable=learnable)
        dct = child(DiscreteCosineTransform, length=n_channel, dct_type=2)
        return Design(
            values={"formatter": _cepstral_formatter(out_format)},
            layers={"fbank": fbank, "dct": dct},
            arrays={"liftering_vector": _lifter(mfcc_order, lifter,
                                                2 ** 0.5)})

    @staticmethod
    def _forward(x: torch.Tensor, *, formatter, fbank, dct,
                 liftering_vector: torch.Tensor):
        y, E = fbank(x)
        y = dct(y)
        y = y[..., : liftering_vector.shape[-1]] * liftering_vector
        c, y = y[..., :1], y[..., 1:]
        return formatter(y, c, E)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)


class PerceptualLinearPredictiveCoefficientsAnalysis(BaseOp):
    """Power spectrum -> PLP coefficients (..., M)."""

    def __init__(self, *, fft_length: int, plp_order: int, n_channel: int,
                 sample_rate: int, compression_factor: float = 0.33,
                 lifter: int = 1, f_min: float = 0,
                 f_max: float | None = None, floor: float = 1e-5,
                 gamma: float = 0, scale: str = "htk",
                 erb_factor: float | None = None, n_fft: int = 512,
                 out_format: str | int = "y", learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = fft_length // 2 + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(plp_order: int, n_channel: int, compression_factor: float,
               lifter: int) -> None:
        if plp_order < 0:
            raise ValueError("plp_order must be non-negative.")
        if n_channel <= plp_order:
            raise ValueError("plp_order must be less than n_channel.")
        if compression_factor <= 0:
            raise ValueError("compression_factor must be positive.")
        if lifter < 0:
            raise ValueError("lifter must be non-negative.")

    @staticmethod
    def _design(fft_length: int, plp_order: int, n_channel: int,
                sample_rate: int, compression_factor: float = 0.33,
                lifter: int = 1, f_min: float = 0,
                f_max: float | None = None, floor: float = 1e-5,
                gamma: float = 0, scale: str = "htk",
                erb_factor: float | None = None, n_fft: int = 512,
                out_format: str | int = "y",
                learnable: bool = False) -> Design:
        PerceptualLinearPredictiveCoefficientsAnalysis._check(
            plp_order, n_channel, compression_factor, lifter)
        fbank = child(MelFilterBankAnalysis, fft_length=fft_length,
                      n_channel=n_channel, sample_rate=sample_rate,
                      f_min=f_min, f_max=f_max, floor=floor, gamma=gamma,
                      scale=scale, erb_factor=erb_factor, use_power=True,
                      out_format="y,E", learnable=learnable)
        levdur = child(LevinsonDurbin, lpc_order=plp_order, eps=0)
        lpc2c = child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                      in_order=plp_order, in_alpha=0, in_gamma=-1,
                      in_norm=True, in_mul=True, out_order=plp_order,
                      out_alpha=0, out_gamma=0, out_norm=False,
                      out_mul=False, n_fft=n_fft)

        if f_max is None:
            f_max = sample_rate / 2
        mel_min = hz_to_auditory(f_min, scale)
        mel_max = hz_to_auditory(f_max, scale)
        seed = np.arange(1, n_channel + 2)
        center = (mel_max - mel_min) / (n_channel + 1) * seed + mel_min
        f = auditory_to_hz(center, scale)[:-1] ** 2
        elc = (f / (f + 1.6e5)) ** 2 * (f + 1.44e6) / (f + 9.61e6)

        return Design(
            values={"compression_factor": compression_factor,
                    "formatter": _cepstral_formatter(out_format)},
            layers={"fbank": fbank, "levdur": levdur, "lpc2c": lpc2c},
            arrays={"equal_loudness_curve": elc,
                    "liftering_vector": _lifter(plp_order, lifter, 2.0)})

    @staticmethod
    def _forward(x: torch.Tensor, *, compression_factor: float, formatter,
                 fbank, levdur, lpc2c, equal_loudness_curve: torch.Tensor,
                 liftering_vector: torch.Tensor):
        y, E = fbank(x)
        y = (torch.exp(y) * equal_loudness_curve) ** compression_factor
        # replicate one sample at each end
        y = torch.cat([y[..., :1], y, y[..., -1:]], dim=-1)
        # numpy's and torch's hfft scale alike: norm="forward" is 1/n
        y = torch.fft.hfft(y, norm="forward")[
            ..., : liftering_vector.shape[-1]]
        y = lpc2c(levdur(y)) * liftering_vector
        c, y = y[..., :1], y[..., 1:]
        return formatter(y, c, E)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of spectrum")
        return super().forward(x)
