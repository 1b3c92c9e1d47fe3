"""Band aperiodicity extraction: TANDEM-STRAIGHT and D4C (counterpart of
``diffsptk_tpu/ops/ap.py``).

TANDEM: QMF decimation (stride-2 convolution), f0-dependent window
extraction through the windowed-gather kernel (kernels/gather.py, one
launch for all bands), and a 6-tap least-squares periodic fit per band
and frame (``utils/linalg.spd_solve``).  D4C: static group delay and
coarse aperiodicity from windowed waveforms, and log-linear
interpolation to fft_length/2+1 bins as a static one-hot matmul.  No
gradient flows through F0.

The sharded TANDEM path of the JAX package (its ``n_offset``,
``band_bases``, ``band_fix`` and ``carry_fix`` arguments) is not ported
yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import child, full_precision, place
from ..kernels.gather import gather_windows
from ..utils.linalg import spd_solve
from .spec import Spectrum
from .window import design_window
from .world_common import (
    dc_correction,
    get_windowed_waveform,
    linear_smoothing,
)


def _qmf_high() -> np.ndarray:
    h = np.zeros(41)
    vals = [+0.00041447996898231424, +0.00078125051417292477,
            -0.0010917236836275842, -0.0019867925675967589,
            +0.0020903896961562292, +0.0040940570272849346,
            -0.0034025808529816698, -0.0074961541272056016,
            +0.0049722633399330637, +0.012738791249119802,
            -0.0066960326895749113, -0.020694051570247052,
            +0.0084324365650413451, +0.033074383758700532,
            -0.010018936738799522, -0.054231361405808247,
            +0.011293988915051487, +0.10020081367388213,
            -0.012120546202484579, -0.31630021039095702,
            +0.51240682580627639]
    h[:21] = vals
    h[21:] = h[19::-1]
    return h


def _qmf_low() -> np.ndarray:
    h = np.zeros(37)
    vals = [-0.00065488170077483048, +0.00007561994958159384,
            +0.0020408456937895227, -0.00074680535322030437,
            -0.0043502235688264931, +0.0025966428382642732,
            +0.0076396022827566962, -0.0064904118901497852,
            -0.011765804538954506, +0.013649908479276255,
            +0.01636866479016021, -0.026075976030529347,
            -0.020910294856659444, +0.048260725032316647,
            +0.024767846611048111, -0.096178467583360641,
            -0.027359756709866623, +0.31488052161630042,
            +0.52827343594055032]
    h[:19] = vals
    h[19:] = h[17::-1]
    return h


def _conv_stride2(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Reflection-padded cross-correlation with stride 2 over (B, T):
    ceil(T/2) outputs for an odd filter length.  Callers run it under
    ``full_precision`` (cuDNN would otherwise round to TF32)."""
    k = h.shape[0]
    pad = k // 2
    xp = F.pad(x[:, None, :], (pad, pad), mode="reflect")
    return F.conv1d(xp, h.reshape(1, 1, k), stride=2)[:, 0]


def _tandem_pad(tmp_fs: float, segment_length: int) -> int:
    """Edge padding covering the worst-case window overhang: after the
    f0 <= 32 -> default replacement, pitch = tmp_fs / f0 is bounded by
    tmp_fs / 32."""
    return int(1.5 * tmp_fs / 32) + segment_length + 8


def _make_interp(coarse_axis: np.ndarray, fft_length: int,
                 sample_rate: int):
    """Static interpolation design: one-hot selection matrix + weights."""
    freq_axis = np.arange(fft_length // 2 + 1) * (sample_rate / fft_length)
    idx = np.searchsorted(coarse_axis, freq_axis) - 1
    idx = np.clip(idx, 0, len(coarse_axis) - 2)
    x0 = coarse_axis[:-1]
    dx = coarse_axis[1:] - x0
    weights = (freq_axis - np.take(x0, idx)) / np.take(dx, idx)
    select = np.zeros((len(coarse_axis) - 1, len(freq_axis)))
    select[idx, np.arange(len(freq_axis))] = 1.0
    return select, weights


class AperiodicityExtractionByTANDEM(nn.Module):
    """TANDEM-STRAIGHT band aperiodicity."""

    def __init__(self, frame_period: int, sample_rate: int,
                 fft_length: int | None = None, *,
                 window_length_ms: float = 30, eps: float = 1e-5,
                 dtype=None, device=None) -> None:
        super().__init__()
        if window_length_ms <= 0:
            raise ValueError("window_length_ms must be positive.")
        if eps <= 0:
            raise ValueError("eps must be positive.")
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.n_band = int(np.log2(sample_rate / 600))
        self.default_f0 = 150

        self.cutoff_list = [sample_rate / 2 ** i
                            for i in range(2, self.n_band + 1)]
        self.cutoff_list.append(self.cutoff_list[-1])

        self.has_interp = fft_length is not None
        if self.has_interp:
            coarse_axis = [sample_rate / 2 ** i
                           for i in range(self.n_band, 0, -1)]
            coarse_axis.insert(0, 0)
            select, weights = _make_interp(
                np.asarray(coarse_axis, np.float64), fft_length,
                sample_rate)
            self.register_buffer("interp_select", torch.as_tensor(select))
            self.register_buffer("interp_weights", torch.as_tensor(weights))

        self.segment_length = [int(c * window_length_ms / 500 + 1.5)
                               for c in self.cutoff_list]
        self.register_buffer("eye", torch.as_tensor(np.eye(6) * eps))
        self.register_buffer("hHP", torch.as_tensor(_qmf_high()))
        self.register_buffer("hLP", torch.as_tensor(_qmf_low()))
        window = np.zeros((self.n_band, self.segment_length[0]))
        for i, s in enumerate(self.segment_length):
            window[i, :s] = np.hanning(s + 2)[1:-1]
        self.register_buffer("window", torch.as_tensor(window))
        self.register_buffer("window_sqrt", torch.as_tensor(np.sqrt(window)))
        place(self, device, dtype)

    def _interp_bap(self, bap: list[torch.Tensor]) -> torch.Tensor:
        bap.append(bap[-1])
        ap = torch.stack(bap[::-1], dim=-1)                     # (B, N, D)
        if self.has_interp:
            y = torch.log(ap)
            y0 = y[..., :-1]
            dy = y[..., 1:] - y0
            yi = ((dy @ self.interp_select) * self.interp_weights
                  + y0 @ self.interp_select)
            ap = torch.exp(yi)
        return ap

    def _merged_bands(self, x: torch.Tensor, f0: torch.Tensor,
                      time_axis: torch.Tensor) -> torch.Tensor:
        """All bands at once: one windowed gather over the bands' padded
        signals laid end to end, one batched 6x6 solve, one set of
        reductions (band as a batch axis; each band's segment length J_i
        rides in its zero-padded window row)."""
        B, N = f0.shape
        nb = self.n_band
        Jmax = self.segment_length[0]
        Wn = Jmax + 2

        xs = []
        lx = x
        for i in range(nb):
            if i < nb - 1:
                xs.append(_conv_stride2(lx, self.hHP))
                lx = _conv_stride2(lx, self.hLP)
            else:
                xs.append(lx)

        segs, starts_all = [], []
        offset = 0
        for i in range(nb):
            tmp_fs = 2 * self.cutoff_list[i]
            pitch = tmp_fs / f0
            t0 = (pitch + 0.5).to(torch.int32)
            index_bias = (pitch * 0.5 + 0.5).to(torch.int32)
            curr_pos = (time_axis * tmp_fs + 1.5).to(torch.int32)[None, :]
            origin = curr_pos - index_bias                      # (B, N)
            J = self.segment_length[i]
            pad = _tandem_pad(tmp_fs, J)
            xp = F.pad(xs[i][:, None], (pad, pad), mode="replicate")[:, 0]
            xp = F.pad(xp, (0, Wn))                # guard for over-reads
            starts_all.append(torch.cat(
                [origin - t0 - 1, origin + t0 - 1, origin],
                dim=-1) + (pad + offset))                       # (B, 3N)
            segs.append(xp)
            offset += xp.shape[-1]
        buf = torch.cat(segs, dim=-1)
        starts = torch.cat(starts_all, dim=-1)                  # (B, nb*3N)
        win = gather_windows(buf, starts, Wn)
        win = win.reshape(B, nb, 3, N, Wn)

        cols = [win[:, :, p, :, s:s + Jmax]
                for p in range(2) for s in range(3)]          # 6x(B,nb,N,J)
        X = win[:, :, 2, :, :Jmax]
        w = self.window[None, :, None, :]                     # (1,nb,1,J)
        wc = [w * c for c in cols]
        ent = {}
        for p in range(6):
            for q in range(p, 6):
                ent[(p, q)] = torch.sum(wc[p] * cols[q], dim=-1)
        R = torch.stack(
            [torch.stack([ent[(min(p, q), max(p, q))] for q in range(6)],
                         dim=-1) for p in range(6)], dim=-2)  # (B,nb,N,6,6)
        rhs = torch.stack([torch.sum(wc[p] * X, dim=-1)
                           for p in range(6)], dim=-1)        # (B,nb,N,6)
        a = spd_solve(R + self.eye, rhs)
        Ha = sum(a[..., p:p + 1] * cols[p] for p in range(6))

        wsq = self.window_sqrt[None, :, None, :]
        wx = wsq * X
        wxHa = wsq * (X - Ha)
        counts = torch.as_tensor(self.segment_length, dtype=f0.dtype,
                                 device=f0.device)[None, :, None]
        jmask = (torch.arange(Jmax, device=f0.device)[None, None, None, :]
                 < counts[..., None]).to(f0.dtype)            # (1,nb,1,J)

        def _std(v):
            # two-pass std over each band's first J_i entries
            m = torch.sum(v, dim=-1, keepdim=True) / counts[..., None]
            d = (v - m) * jmask
            return torch.sqrt(torch.sum(d * d, dim=-1) / (counts - 1))

        bap_b = _std(wxHa) / (_std(wx) + 1e-16)               # (B, nb, N)
        return self._interp_bap([bap_b[:, i] for i in range(nb)])

    def forward(self, x: torch.Tensor, f0: torch.Tensor, n_offset=0,
                band_bases=None, band_fix=None,
                carry_fix=None) -> torch.Tensor:
        if (n_offset != 0 or band_bases is not None or band_fix is not None
                or carry_fix is not None):
            raise NotImplementedError(
                "the sharded TANDEM path is not ported yet")
        f0 = torch.where(f0 <= 32, torch.full_like(f0, self.default_f0),
                         f0).detach()
        N = f0.shape[-1]
        time_axis = torch.arange(N, dtype=f0.dtype, device=f0.device) * (
            self.frame_period / self.sample_rate)
        return self._merged_bands(x, f0, time_axis)


class AperiodicityExtractionByD4C(nn.Module):
    """D4C band aperiodicity (Morise 2016)."""

    def __init__(self, frame_period: int, sample_rate: int,
                 fft_length: int | None = None, *, threshold: float = 0,
                 default_f0: float = 150, f0_ceil: float = 1200.0,
                 dtype=None, device=None) -> None:
        super().__init__()
        if sample_rate < 12000:
            raise ValueError("sample_rate must be at least 12000 Hz.")
        if threshold < 0:
            raise ValueError("threshold must be non-negative.")
        if default_f0 <= 0:
            raise ValueError("default_f0 must be positive.")
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.threshold = threshold
        self.default_f0 = default_f0
        self.f0_ceil = max(f0_ceil, default_f0)

        frequency_interval = 3000
        upper_limit = 15000
        floor_f0 = 47
        self.lowest_f0 = 40

        self.fft_length_love = 2 ** (
            1 + int(np.log(3 * sample_rate / self.lowest_f0 + 1)
                    / np.log(2)))
        self.fft_length_d4c = 2 ** (
            1 + int(np.log(4 * sample_rate / floor_f0 + 1) / np.log(2)))

        n_ap = int(min(upper_limit, sample_rate / 2 - frequency_interval)
                   / frequency_interval)
        window_length = (frequency_interval * self.fft_length_d4c
                         // sample_rate * 2 + 1)
        half = window_length // 2
        padded = self.fft_length_d4c // 2 + 1
        win = design_window(window_length, "nuttall", norm="none")
        windows = []
        for i in range(1, n_ap + 1):
            center = frequency_interval * i * self.fft_length_d4c // sample_rate
            left = center - half
            right = center + half + 1
            windows.append(np.pad(win, (left, padded - right)))
        self.register_buffer("windows", torch.as_tensor(np.stack(windows)))
        self.window_length = window_length

        self.has_interp = fft_length is not None
        if self.has_interp:
            coarse_axis = np.arange(n_ap + 2, dtype=np.float64) \
                * frequency_interval
            coarse_axis[-1] = sample_rate / 2
            select, weights = _make_interp(coarse_axis, fft_length,
                                           sample_rate)
            self.register_buffer("interp_select", torch.as_tensor(select))
            self.register_buffer("interp_weights", torch.as_tensor(weights))

        self.spec_love = child(Spectrum, fft_length=self.fft_length_love)
        self.spec_d4c = child(Spectrum, fft_length=self.fft_length_d4c)
        self.register_buffer("ramp", torch.arange(self.fft_length_d4c,
                                                  dtype=torch.float64))
        rate_d4c = sample_rate / self.fft_length_d4c
        self.max_boundary = int(self.f0_ceil / rate_d4c) + 2
        place(self, device, dtype)

    def forward(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        eps = 1e-12
        f0 = torch.where(f0 < self.lowest_f0,
                         torch.full_like(f0, self.default_f0),
                         f0).detach()[..., None]
        f0 = torch.clamp(f0, max=self.f0_ceil)
        sr, L = self.sample_rate, self.fft_length_d4c

        # D4CLoveTrain()
        if 0 < self.threshold:
            waveform = get_windowed_waveform(
                x, f0, 3, 0, self.frame_period, sr, self.fft_length_love,
                "blackman", False, 1e-6, self.ramp)
            ps = self.spec_love(waveform)
            rate = sr / self.fft_length_love
            b0 = math.ceil(100 / rate) + 1
            b1 = math.ceil(4000 / rate)
            b2 = math.ceil(7900 / rate)
            ps = torch.cumsum(ps[..., b0:], dim=-1)
            aperiodicity0 = (ps[..., b1 - b0] / ps[..., b2 - b0])[..., None]

        # GetStaticCentroid()
        def get_centroid(bias_ratio):
            waveform = get_windowed_waveform(
                x, f0, 4, bias_ratio, self.frame_period, sr, L, "blackman",
                False, 1e-6, self.ramp)
            power = torch.sum(torch.square(waveform), dim=-1, keepdim=True)
            waveform = waveform / torch.sqrt(power)
            # 1-based positions over the window support, in closed form
            # (the dither makes every in-window sample non-zero).
            half = torch.round(2.0 * sr / f0)
            bias = torch.round(bias_ratio * sr / f0)
            base = self.ramp[:L] - bias - L // 2
            mask = (-half <= base) & (base <= half)
            pos = (base + half + 1) * mask
            s1 = torch.fft.rfft(waveform, n=L)
            s2 = torch.fft.rfft(waveform * pos.to(waveform.dtype), n=L)
            return s1.real * s2.real + s1.imag * s2.imag

        static_centroid = get_centroid(-0.25) + get_centroid(0.25)
        static_centroid = dc_correction(static_centroid, f0, sr, L,
                                        self.ramp,
                                        max_bins=self.max_boundary)

        # GetSmoothedPowerSpectrum()
        waveform = get_windowed_waveform(
            x, f0, 4, 0, self.frame_period, sr, self.fft_length_love,
            "hanning", False, 1e-6, self.ramp)
        power_spectrum = self.spec_d4c(waveform)
        power_spectrum = dc_correction(power_spectrum, f0, sr, L, self.ramp,
                                       max_bins=self.max_boundary)
        smoothed = linear_smoothing(power_spectrum, f0, sr, L, self.ramp,
                                    self.max_boundary)

        # GetStaticGroupDelay()
        sgd = static_centroid / (smoothed + eps)
        sgd = linear_smoothing(sgd, f0 / 2, sr, L, self.ramp,
                               self.max_boundary)
        smoothed_gd = linear_smoothing(sgd, f0, sr, L, self.ramp,
                                       self.max_boundary)
        sgd = sgd - smoothed_gd

        # GetCoarseAperiodicity(): only the top (boundary+1) peak mass of
        # the sorted spectrum is needed.
        boundary = round(L * 8 / self.window_length)
        ps = self.spec_d4c(sgd[..., None, :] * self.windows)
        total = torch.sum(ps, dim=-1)
        peaks = torch.topk(ps, boundary + 1, dim=-1).values
        numer = torch.clamp(total - torch.sum(peaks, dim=-1), min=1e-30)
        coarse = 10 * torch.log10(numer / total)
        coarse = torch.clamp(coarse + (f0 - 100) / 50, max=-eps)

        # GetAperiodicity()
        y = coarse
        if self.has_interp:
            y = F.pad(y, (1, 0), value=-60.0)
            y = F.pad(y, (0, 1), value=-eps)
            y0 = y[..., :-1]
            dy = y[..., 1:] - y0
            y = ((dy @ self.interp_select) * self.interp_weights
                 + y0 @ self.interp_select)
        aperiodicity = 10 ** (y / 20)

        if 0 < self.threshold:
            aperiodicity = torch.where(aperiodicity0 <= self.threshold,
                                       torch.full_like(aperiodicity, 1 - eps),
                                       aperiodicity)
        return aperiodicity


class Aperiodicity(nn.Module):
    """(waveform (B?, T), f0 in Hz (B?, T/P)) -> aperiodicity
    (B?, T/P, L/2+1) (or band aperiodicity when fft_length is None)."""

    def __init__(self, frame_period: int, sample_rate: int,
                 fft_length: int | None = None, algorithm: str = "tandem",
                 out_format: str | int = "a", lower_bound: float = 0.001,
                 upper_bound: float = 0.999, dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if sample_rate < 8000:
            raise ValueError("sample_rate must be at least 8000 Hz.")
        if fft_length is not None and fft_length < 16:
            raise ValueError("fft_length must be at least 16.")
        if not 0 <= lower_bound < upper_bound <= 1:
            raise ValueError("Invalid lower_bound and upper_bound.")
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

        if algorithm == "tandem":
            cls = AperiodicityExtractionByTANDEM
        elif algorithm == "d4c":
            cls = AperiodicityExtractionByD4C
        else:
            raise ValueError(f"algorithm {algorithm} is not supported.")
        self.extractor = child(cls, frame_period=frame_period,
                               sample_rate=sample_rate,
                               fft_length=fft_length, **kwargs)

        if out_format in (0, "a"):
            self.convert = lambda ap: ap
        elif out_format in (1, "p"):
            self.convert = lambda ap: 1 - ap
        elif out_format in (2, "a/p"):
            self.convert = lambda ap: ap / (1 - ap)
        elif out_format in (3, "p/a"):
            self.convert = lambda ap: (1 - ap) / ap
        else:
            raise ValueError(f"out_format {out_format} is not supported.")
        place(self, device, dtype)

    @full_precision
    def forward(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        one_d = x.ndim == 1
        if one_d:
            x = x[None]
            f0 = f0[None]
        ap = self.extractor(x, f0)
        ap = torch.clamp(ap, self.lower_bound, self.upper_bound)
        ap = self.convert(ap)
        if one_d:
            ap = ap[0]
        return ap
