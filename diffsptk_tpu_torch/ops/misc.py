"""Miscellaneous ops: decimation, interpolation and delay; metrics
(entropy, histogram, SNR, RMSE, flux, zero crossings, F0 evaluation);
group delay and phase; the Yingram; the median filter and magic-number
interpolation (counterpart of ``diffsptk_tpu/ops/misc.py``).

None of them reads the card back: masks are arithmetic (``torch.where``
and sums), never a boolean index.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from ..utils.linalg import remove_gain
from .acorr import Autocorrelation


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return x
    if reduction == "sum":
        return torch.sum(x)
    if reduction == "mean":
        return torch.mean(x)
    raise ValueError(f"reduction {reduction} is not supported.")


def _zeros_along(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape)


class Decimation(BaseOp):
    """Every P-th sample from S along ``dim``."""

    def __init__(self, period: int, start: int = 0, dim: int = -1,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(period: int, start: int) -> None:
        if period <= 0:
            raise ValueError("period must be positive.")
        if start < 0:
            raise ValueError("start must be non-negative.")

    @staticmethod
    def _design(period: int, start: int = 0, dim: int = -1) -> Design:
        Decimation._check(period, start)
        return Design(values={"period": period, "start": start, "dim": dim})

    @staticmethod
    def _forward(x, *, period, start, dim):
        sl = [slice(None)] * x.ndim
        sl[dim % x.ndim] = slice(start, None, period)
        return x[tuple(sl)]


class Interpolation(BaseOp):
    """Zero-stuffing upsampler (the inverse of :class:`Decimation`)."""

    def __init__(self, period: int, start: int = 0, dim: int = -1,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(period: int, start: int) -> None:
        Decimation._check(period, start)

    @staticmethod
    def _design(period: int, start: int = 0, dim: int = -1) -> Design:
        Decimation._check(period, start)
        return Design(values={"period": period, "start": start, "dim": dim})

    @staticmethod
    def _forward(x, *, period, start, dim):
        dim = dim % x.ndim
        T = x.shape[dim] * period + start
        y = _zeros_along(x, dim, T)
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(start, T, period)
        y[tuple(sl)] = x
        return y


class Delay(BaseOp):
    """Integer shift with zero fill; a negative start advances."""

    def __init__(self, start: int, keeplen: bool = False, dim: int = -1,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(start: int, keeplen: bool = False, dim: int = -1) -> Design:
        return Design(values={"start": start, "keeplen": keeplen,
                              "dim": dim})

    @staticmethod
    def _forward(x, *, start, keeplen, dim):
        if start == 0:
            return x
        dim = dim % x.ndim
        T = x.shape[dim]
        if 0 < start:
            y = torch.cat([_zeros_along(x, dim, start), x], dim=dim)
            return y.narrow(dim, 0, T) if keeplen else y
        y = x.narrow(dim, -start, T + start)
        if keeplen:
            y = torch.cat([y, _zeros_along(x, dim, -start)], dim=dim)
        return y


class Entropy(BaseOp):
    """Probabilities (..., K) -> entropy (...,) in bits, nats or dits."""

    def __init__(self, out_format: str | int = "nat", dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(out_format: str | int = "nat") -> Design:
        if out_format in (0, "bit"):
            c = math.log2(math.e)
        elif out_format in (1, "nat"):
            c = 1.0
        elif out_format in (2, "dit"):
            c = math.log10(math.e)
        else:
            raise ValueError(f"out_format {out_format} is not supported.")
        return Design(values={"c": c})

    @staticmethod
    def _forward(p, *, c):
        positive = p > 0
        entr = torch.where(
            positive, -p * torch.log(torch.where(positive, p, 1.0)),
            torch.where(p == 0, torch.zeros_like(p),
                        torch.full_like(p, -math.inf)))
        return c * torch.sum(entr, dim=-1)


class Histogram(BaseOp):
    """Differentiable soft histogram by sigmoid bins."""

    def __init__(self, n_bin: int = 10, lower_bound: float = 0.0,
                 upper_bound: float = 1.0, norm: bool = False,
                 softness: float = 1e-3, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(n_bin: int, lower_bound: float, upper_bound: float,
               softness: float) -> None:
        if n_bin <= 0:
            raise ValueError("n_bin must be positive.")
        if upper_bound <= lower_bound:
            raise ValueError("upper_bound must exceed lower_bound.")
        if softness <= 0:
            raise ValueError("softness must be positive.")

    @staticmethod
    def _design(n_bin: int = 10, lower_bound: float = 0.0,
                upper_bound: float = 1.0, norm: bool = False,
                softness: float = 1e-3) -> Design:
        Histogram._check(n_bin, lower_bound, upper_bound, softness)
        width = (upper_bound - lower_bound) / n_bin
        centers = np.arange(n_bin) * width + lower_bound + 0.5 * width
        return Design(values={"norm": norm, "softness": softness},
                      arrays={"centers": centers})

    @staticmethod
    def _forward(x, *, norm, softness, centers):
        y = x[..., None, :] - centers[..., None]
        g = 0.5 * (centers[1] - centers[0])
        h = (torch.sigmoid((y + g) / softness)
             - torch.sigmoid((y - g) / softness))
        h = torch.sum(h, dim=-1)
        if norm:
            h = h / torch.sum(h, dim=-1, keepdim=True)
        return h


class SignalToNoiseRatio(BaseOp):
    """SNR or segmental SNR in dB: (s, s + noise) -> SNR."""

    def __init__(self, frame_length: int | None = None, full: bool = False,
                 reduction: str = "mean", eps: float = 1e-8, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(frame_length: int | None, eps: float) -> None:
        if frame_length is not None and frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if eps < 0:
            raise ValueError("eps must be non-negative.")

    @staticmethod
    def _design(frame_length: int | None = None, full: bool = False,
                reduction: str = "mean", eps: float = 1e-8) -> Design:
        SignalToNoiseRatio._check(frame_length, eps)
        return Design(values={"frame_length": frame_length,
                              "reduction": reduction, "eps": eps,
                              "const": 10.0 if full else 1.0})

    @staticmethod
    def _forward(s, sn, *, frame_length, reduction, eps, const):
        if frame_length is not None:
            n = s.shape[-1] // frame_length
            s = s[..., :n * frame_length].reshape(
                *s.shape[:-1], n, frame_length)
            sn = sn[..., :n * frame_length].reshape(
                *sn.shape[:-1], n, frame_length)
        s2 = torch.sum(torch.square(s), dim=-1)
        n2 = torch.sum(torch.square(sn - s), dim=-1)
        snr = torch.log10((s2 + eps) / (n2 + eps))
        return const * _reduce(snr, reduction)


class RootMeanSquareError(BaseOp):
    """RMSE over the last axis, with mean, sum or no reduction."""

    def __init__(self, reduction: str = "mean", dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(reduction: str = "mean") -> Design:
        return Design(values={"reduction": reduction})

    @staticmethod
    def _forward(x, y, *, reduction):
        error = torch.linalg.vector_norm(x - y, dim=-1) \
            / (x.shape[-1] ** 0.5)
        return _reduce(error, reduction)


class Flux(BaseOp):
    """Spectral flux between frames ``lag`` apart."""

    def __init__(self, lag: int = 1, norm: int | float = 2,
                 reduction: str = "mean", dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(lag: int = 1, norm: int | float = 2,
                reduction: str = "mean") -> Design:
        return Design(values={"lag": lag, "norm": norm,
                              "reduction": reduction})

    @staticmethod
    def _forward(x, y=None, *, lag, norm, reduction):
        if y is None:
            y = x
        if x.ndim == 1:
            x = x[..., None]
            y = y[..., None]
        if 0 < lag:
            diff = x[..., lag:, :] - y[..., :-lag, :]
        elif lag < 0:
            diff = y[..., -lag:, :] - x[..., :lag, :]
        else:
            diff = x - y
        flux = torch.linalg.vector_norm(diff, ord=norm, dim=-1)
        if reduction == "mean":
            return torch.mean(flux) / (x.shape[-1] ** (1 / norm))
        if reduction == "batchmean":
            return torch.mean(flux)
        return _reduce(flux, reduction)


class ZeroCrossingAnalysis(BaseOp):
    """Zero crossings per frame; a soft sign keeps a gradient path."""

    def __init__(self, frame_length: int, norm: bool = False,
                 softness: float = 1e-3, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(frame_length: int, softness: float) -> None:
        if frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if softness <= 0:
            raise ValueError("softness must be positive.")

    @staticmethod
    def _design(frame_length: int, norm: bool = False,
                softness: float = 1e-3) -> Design:
        ZeroCrossingAnalysis._check(frame_length, softness)
        return Design(values={"frame_length": frame_length, "norm": norm,
                              "softness": softness})

    @staticmethod
    def _forward(x, *, frame_length, norm, softness):
        x = torch.tanh(x / softness)
        # one sample repeated on the left; frames of L + 1 every L samples
        x = torch.cat([x[..., :1], x], dim=-1)
        frames = x.unfold(-1, frame_length + 1, frame_length)
        z = 0.5 * torch.sum(torch.abs(torch.diff(frames, dim=-1)), dim=-1)
        if norm:
            z = z / frame_length
        return z


class GroupDelay(BaseOp):
    """Modified group delay of the filter b / a."""

    def __init__(self, fft_length: int, alpha: float = 1.0,
                 gamma: float = 1.0, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int, alpha: float, gamma: float) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if alpha <= 0:
            raise ValueError("alpha must be positive.")
        if gamma <= 0:
            raise ValueError("gamma must be positive.")

    @staticmethod
    def _design(fft_length: int, alpha: float = 1.0,
                gamma: float = 1.0) -> Design:
        GroupDelay._check(fft_length, alpha, gamma)
        return Design(values={"fft_length": fft_length, "alpha": alpha,
                              "gamma": gamma},
                      arrays={"ramp": np.arange(fft_length)})

    @staticmethod
    def _forward(b=None, a=None, *, fft_length, alpha, gamma, ramp):
        if b is None and a is None:
            raise ValueError("Either b or a must be specified.")
        if a is None:
            order = 0
        else:
            a = remove_gain(a)
            order = a.shape[-1] - 1
        if b is None:
            c = torch.flip(a, (-1,))
        elif a is None:
            c = b
        else:
            # the full convolution of b with the reversed a
            b2 = F.pad(b, (order, order)).unfold(-1, order + 1, 1)
            c = torch.sum(b2 * a[..., None, :], dim=-1)
        data_length = c.shape[-1]
        if fft_length < data_length:
            raise RuntimeError("Please increase FFT length.")
        d = c * ramp[:data_length]
        C = torch.fft.rfft(c, n=fft_length)
        D = torch.fft.rfft(d, n=fft_length)
        numer = C.real * D.real + C.imag * D.imag
        denom = C.real * C.real + C.imag * C.imag
        if gamma != 1:
            denom = torch.pow(denom, gamma)
        g = numer / denom - order
        if alpha != 1:
            g = torch.sign(g) * torch.pow(torch.abs(g), alpha)
        return g


class Phase(BaseOp):
    """Phase spectrum of b / a in units of pi, optionally unwrapped."""

    def __init__(self, fft_length: int, unwrap: bool = False, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(fft_length: int) -> None:
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")

    @staticmethod
    def _design(fft_length: int, unwrap: bool = False) -> Design:
        Phase._check(fft_length)
        return Design(values={"fft_length": fft_length, "unwrap": unwrap})

    @staticmethod
    def _forward(b=None, a=None, *, fft_length, unwrap):
        if b is None and a is None:
            raise ValueError("Either b or a must be specified.")
        if b is not None:
            B = torch.fft.rfft(b, n=fft_length)
        if a is not None:
            A = torch.fft.rfft(remove_gain(a), n=fft_length)
        if b is None:
            numer, denom = -A.imag, A.real
        elif a is None:
            numer, denom = B.imag, B.real
        else:
            numer = B.imag * A.real - B.real * A.imag
            denom = B.real * A.real + B.imag * A.imag
        p = torch.atan2(numer, denom) / math.pi
        if unwrap:
            diff = torch.diff(p, dim=-1)
            bias = 2.0 * ((diff < -1).to(p.dtype) - (1 < diff).to(p.dtype))
            s = torch.cumsum(bias, dim=-1)
            p = torch.cat([p[..., :1], p[..., 1:] + s], dim=-1)
        return p


class Yingram(BaseOp):
    """The YIN cumulative mean normalised difference on MIDI-spaced lags:
    a frame (..., L) -> (..., n_lags)."""

    def __init__(self, frame_length: int, sample_rate: int = 22050,
                 lag_min: int = 22, lag_max: int | None = None,
                 n_bin: int = 20, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = frame_length
        design = self._design(**filter_values(locals()))
        self._setup(design, dtype=dtype, device=device)
        # the interpolation's indices stay integral
        lags = np.asarray(design.arrays["lags"])
        for name, idx in (("lags_ceil", np.ceil(lags)),
                          ("lags_floor", np.floor(lags))):
            self.register_buffer(name, torch.as_tensor(
                idx.astype(np.int64), device=self.lags.device))
        self._array_names += ("lags_ceil", "lags_floor")

    @staticmethod
    def _check(frame_length: int, sample_rate: int, lag_min: int,
               lag_max: int, n_bin: int) -> None:
        if frame_length <= 0:
            raise ValueError("frame_length must be positive.")
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive.")
        if not 1 <= lag_min <= lag_max <= frame_length:
            raise ValueError("Invalid lag_min/lag_max.")
        if n_bin <= 0:
            raise ValueError("n_bin must be positive.")

    @staticmethod
    def _design(frame_length: int, sample_rate: int = 22050,
                lag_min: int = 22, lag_max: int | None = None,
                n_bin: int = 20) -> Design:
        if lag_max is None:
            lag_max = frame_length - 1
        Yingram._check(frame_length, sample_rate, lag_min, lag_max, n_bin)

        def midi2lag(midi):
            return sample_rate / (440 * 2 ** ((midi - 69) / 12))

        def lag2midi(lag):
            return 12 * np.log2(sample_rate / (440 * lag)) + 69

        midi_min = int(np.ceil(lag2midi(lag_max)))
        midi_max = int(lag2midi(lag_min))
        lags = midi2lag(np.arange(midi_min, midi_max + 1, 1 / n_bin))
        return Design(values={"lag_max": lag_max},
                      arrays={"lags": lags, "ramp": np.arange(1, lag_max)})

    @staticmethod
    def _forward(x, *, lag_max, lags, ramp, lags_ceil, lags_floor):
        W = x.shape[-1]
        x0 = F.pad(x, (1, 0))
        s = torch.cumsum(x0 * x0, dim=-1)
        term1 = torch.flip(s[..., W - lag_max + 1:], (-1,))
        term2 = s[..., W:] - s[..., :lag_max]
        term3 = -2 * Autocorrelation._forward(
            x, frame_length=W, acr_order=lag_max - 1, out_format="naive")
        d = (term1 + term2 + term3)[..., 1:]
        d = ramp * d / (torch.cumsum(d, dim=-1) + 1e-7)
        d0 = F.pad(d, (1, 0), value=1.0)
        # The largest lag's ceiling can be lag_max, one past d0; the JAX
        # package's gather clamps it to the last element, and so does this.
        ceil = torch.clamp(lags_ceil, max=d0.shape[-1] - 1)
        numer = (lags - lags_floor) * (d0[..., ceil] - d0[..., lags_floor])
        denom = (lags_ceil - lags_floor).to(d0.dtype)
        return numer / denom + d0[..., lags_floor]

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "frame length")
        return super().forward(x)


def nan_median(y: torch.Tensor) -> torch.Tensor:
    """The median over the last axis ignoring NaN, the mean of the two
    middle values for an even count (``nanquantile(y, 0.5)``, linear),
    NaN where every value is NaN.  By a sort, which puts NaN last, so it
    takes any size (``torch.nanquantile`` refuses more than 2^24
    elements)."""
    s = torch.sort(y, dim=-1).values
    n = torch.sum(~torch.isnan(y), dim=-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    v_lo = torch.gather(s, -1, lo)[..., 0]
    v_hi = torch.gather(s, -1, hi)[..., 0]
    med = v_lo + (v_hi - v_lo) * 0.5
    return torch.where(n[..., 0] > 0, med, math.nan)


class MedianFilter(BaseOp):
    """Median filter over time with NaN padding and magic-number masking:
    (T,), (T, D) or (B, T, D) -> the same shape."""

    def __init__(self, filter_length: int, across_features: bool = False,
                 magic_number: float | None = None, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(filter_length: int) -> None:
        if filter_length <= 0:
            raise ValueError("filter_length must be positive.")

    @staticmethod
    def _design(filter_length: int, across_features: bool = False,
                magic_number: float | None = None) -> Design:
        MedianFilter._check(filter_length)
        if filter_length % 2 == 1:
            padding = ((filter_length - 1) // 2, (filter_length - 1) // 2)
        else:
            padding = (filter_length // 2, (filter_length - 2) // 2)
        return Design(values={"filter_length": filter_length,
                              "padding": padding,
                              "across_features": across_features,
                              "magic_number": magic_number})

    @staticmethod
    def _forward(x, *, filter_length, padding, across_features,
                 magic_number):
        d = x.ndim
        if d == 1:
            x = x.reshape(1, -1, 1)
        elif d == 2:
            x = x[None]
        if x.ndim != 3:
            raise ValueError("Input must be 1D, 2D, or 3D tensor.")

        def windows(v):
            """(B, T, D) padded with NaN in time -> (B, T, D, L)."""
            return F.pad(v, (0, 0) + tuple(padding), value=math.nan).unfold(
                1, filter_length, 1)

        if magic_number is not None:
            mask = x == magic_number
            x = torch.where(mask, math.nan, x)
        y = windows(x)
        if across_features:
            y = y.reshape(*y.shape[:2], -1)
        out = nan_median(y)

        if magic_number is not None:
            m = windows(mask.to(x.dtype))
            if across_features:
                m = m.reshape(*m.shape[:2], -1)
            magic_count = torch.nansum(m, dim=-1)
            valid_count = torch.nansum(1 - m, dim=-1)
            out = torch.where(magic_count > valid_count, magic_number, out)

        if d == 1:
            out = out.reshape(-1)
        elif d == 2:
            out = out[0]
        return out


class MagicNumberInterpolation(BaseOp):
    """Fill magic values by linear interpolation between the nearest valid
    neighbours (constant extrapolation at the edges); the neighbours'
    indices come from ``torch.cummax``, so nothing is read back."""

    def __init__(self, magic_number: float = 0.0, dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(magic_number: float = 0.0) -> Design:
        return Design(values={"magic_number": magic_number})

    @staticmethod
    def _forward(x, *, magic_number):
        d = x.ndim
        if d == 1:
            x = x.reshape(1, -1, 1)
        elif d == 2:
            x = x[None]
        if x.ndim != 3:
            raise ValueError("Input must be 1D, 2D, or 3D tensor.")
        T = x.shape[1]

        valid = x != magic_number
        t = torch.arange(T, device=x.device)[None, :, None]
        prev_idx = torch.cummax(torch.where(valid, t, -1), dim=1).values
        nxt = torch.where(valid, t, T)
        next_idx = -torch.flip(torch.cummax(torch.flip(-nxt, (1,)),
                                            dim=1).values, (1,))
        has_prev = prev_idx >= 0
        has_next = next_idx < T
        pi = torch.clamp(prev_idx, 0, T - 1)
        ni = torch.clamp(next_idx, 0, T - 1)
        xv_prev = torch.gather(x, 1, pi)
        xv_next = torch.gather(x, 1, ni)
        # constant extrapolation where a side is missing
        left = torch.where(has_prev, xv_prev, xv_next)
        right = torch.where(has_next, xv_next, xv_prev)
        span = torch.clamp(ni - pi, min=1)
        w = torch.where(has_prev & has_next, (t - pi).to(x.dtype) / span,
                        0.0)
        out = torch.where(valid, x, left * (1 - w) + right * w)

        if d == 1:
            out = out.reshape(-1)
        elif d == 2:
            out = out[0]
        return out


class F0Evaluation(BaseOp):
    """F0 RMSE (Hz, cents or semitones) over frames voiced in both, or the
    voiced/unvoiced error rate, percentage or macro F1."""

    def __init__(self, reduction: str = "mean",
                 out_format: str = "f0-rmse-cent", dtype=None,
                 device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check() -> None:
        pass

    @staticmethod
    def _design(reduction: str = "mean",
                out_format: str = "f0-rmse-cent") -> Design:
        return Design(values={"reduction": reduction,
                              "out_format": out_format})

    @staticmethod
    def _forward(x, y, *, reduction, out_format):
        UNVOICED = 0
        dt = x.dtype if x.is_floating_point() else torch.get_default_dtype()
        if out_format.startswith("f0-rmse"):
            voiced = (x != UNVOICED) & (y != UNVOICED)
            if out_format == "f0-rmse-hz":
                scale = None
            elif out_format == "f0-rmse-cent":
                scale = 1200
            elif out_format == "f0-rmse-semitone":
                scale = 12
            else:
                raise ValueError(
                    f"out_format {out_format} is not supported.")

            def convert(v):
                if scale is None:
                    return v
                return scale * torch.log2(torch.where(v > 0, v, 1.0))

            se = torch.square(convert(x) - convert(y)) * voiced
            count = torch.clamp(torch.sum(voiced), min=1)
            out = torch.sqrt(torch.sum(se) / count)
        else:
            xv, yv = x != UNVOICED, y != UNVOICED
            TP = torch.sum(xv & yv, dim=-1).to(dt)
            FP = torch.sum(xv & ~yv, dim=-1).to(dt)
            FN = torch.sum(~xv & yv, dim=-1).to(dt)
            TN = torch.sum(~xv & ~yv, dim=-1).to(dt)
            FPFN = FP + FN
            if out_format == "vuv-error-rate":
                out = FPFN / x.shape[-1]
            elif out_format == "vuv-error-percent":
                out = 100 * FPFN / x.shape[-1]
            elif out_format == "vuv-macro-f1-score":
                f1p = torch.nan_to_num((2 * TP) / (2 * TP + FPFN))
                f1n = torch.nan_to_num((2 * TN) / (2 * TN + FPFN))
                out = (f1p + f1n) / 2
            else:
                raise ValueError(
                    f"out_format {out_format} is not supported.")
        return _reduce(out, reduction)
