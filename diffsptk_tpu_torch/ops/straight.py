"""STRAIGHT spectral-envelope extraction (counterpart of
``diffsptk_tpu/ops/straight.py``).

Kawahara's pitch-adaptive time-frequency smoothing [Kawahara et al. 1999].
The design-time constants (Butterworth band splits, the pitch-synchronous
Gaussian-Bartlett window seed, the smoothing and compensation
coefficients) are built on the host in numpy float64; the per-frame
pipeline is plain torch (FFTs, gathers, elementwise).  The band-split
highpass filters run as biquad cascades through ``kernels/recurrence.py``'s
``lfilter``, whose all-pole part is the plain blocked recurrence.

``optimum_smoothing`` re-derives the over-smoothing compensation
coefficients as the JAX package does (a least-squares fit that minimizes
the time-frequency ripple of the smoothed pulse-train spectrogram); pass
``ovc=`` to use others.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core import place
from ..kernels.recurrence import lfilter
from .world_common import frames_matching_f0

TAU = 2 * np.pi


@functools.lru_cache(maxsize=None)
def optimum_smoothing_system(eta: float = 1.0, pc: float = 0.6):
    """The (A, b) least-squares system behind ``optimum_smoothing``."""
    return _ovc_system(eta, pc)


@functools.lru_cache(maxsize=None)
def optimum_smoothing(eta: float = 1.0, pc: float = 0.6) -> tuple:
    """Optimum smoothing-compensation coefficients (length 4).

    The second stage reconstructs the envelope from a harmonically
    sampled, window-blurred spectrum by smoothing with a mixture of
    triangular kernels displaced by 0..3 harmonics.  The coefficients are
    the least-squares solution over harmonic signals with random smooth
    envelopes, run through the analysis (eta-stretched Gaussian-Bartlett
    window pair, power ``pc`` compression, sinc(3q)^2 pre-smoother) over
    all window phases, in normalized units (f0 = 1).
    """
    A, b = _ovc_system(eta, pc)
    ovc, *_ = np.linalg.lstsq(A, b, rcond=None)
    return tuple(float(v) for v in ovc)


@functools.lru_cache(maxsize=None)
def _ovc_system(eta: float, pc: float):
    rng = np.random.RandomState(0)
    df = 1.0 / 32.0                 # frequency resolution (f0 units)
    F = 16.0                        # frequency extent
    K = 6                           # pulses each side of the window
    R = 16                          # window phases per period
    n_env = 12                      # random envelopes

    # Window seed: Gaussian (temporal stretch eta) (*) Bartlett, in
    # continuous normalized time.
    tfine = np.arange(-K, K + 1e-12, 1.0 / 256.0)
    gauss = np.exp(-np.pi * (tfine / eta) ** 2)
    bart = np.maximum(0.0, 1.0 - np.abs(tfine))
    seed = np.convolve(gauss, bart, mode="same")
    seed /= seed.max()

    f = np.arange(0.0, F, df)                    # (Nf,)
    H = int(F) + K
    hh = np.arange(1, H + 1)
    t0 = np.arange(R) / R

    def tri_kernel(width):
        n = int(round(width / df))
        kern = 1.0 - np.abs(np.arange(-n, n + 1)) / n
        return kern / kern.sum()

    def conv_f(z, kern):
        pad = len(kern) // 2
        zp = np.pad(z, [(0, 0), (pad, pad)], mode="edge")
        return np.stack([np.convolve(zp[i], kern, mode="valid")
                         for i in range(z.shape[0])])

    k3 = tri_kernel(3.0)
    k1 = tri_kernel(1.0)
    shift = int(round(1.0 / df))
    lo, hi = int(5.0 / df), int(11.0 / df)       # interior band, edge-safe

    rows, tgts = [], []
    for _ in range(n_env):
        # Smooth positive envelope: random low-order cosine log-envelope.
        nc = 3
        coef = rng.randn(nc) * 0.8
        loga = sum(c * np.cos(2 * np.pi * (i + 1) * hh / (2.2 * H))
                   for i, c in enumerate(coef))
        a = np.exp(loga)
        env_f = np.exp(sum(c * np.cos(2 * np.pi * (i + 1) * f / (2.2 * H))
                           for i, c in enumerate(coef)))

        # Windowed spectra of x(t) = sum_h a_h cos(2 pi h t) over all
        # phases, the window's transform by direct sums over its samples.
        dt = 1.0 / 64.0
        ts = np.arange(-K, K + dt / 2, dt)       # (Nt,)
        wet = np.interp(ts, tfine, seed, left=0, right=0)
        wet = wet / np.sqrt((wet**2).sum() * dt)
        wdt = 0.36 * wet * np.sin(np.pi * ts)
        sigs = np.stack([(a[None, :] * np.cos(2 * np.pi * hh[None, :]
                                              * (ts + o)[:, None])).sum(-1)
                         for o in t0])           # (R, Nt)
        ph = np.exp(-2j * np.pi * f[None, :] * ts[:, None])   # (Nt, Nf)
        Xe = (wet * sigs) @ ph * dt
        Xd = (wdt * sigs) @ ph * dt
        pw = (np.abs(Xe) ** 2 + np.abs(Xd) ** 2) ** (pc / 2)

        spw2 = conv_f(pw, k3)
        r = pw / np.maximum(spw2, 1e-30)
        C = conv_f(r, k1)
        cols = [C[:, lo:hi]]
        for j in (1, 2, 3):
            cols.append(C[:, lo - j * shift:hi - j * shift]
                        + C[:, lo + j * shift:hi + j * shift])
        rows.append(np.stack([c.ravel() for c in cols], axis=1))
        target = (env_f[None, lo:hi] ** pc
                  / np.maximum(spw2[:, lo:hi], 1e-30))
        tgts.append(target.ravel())

    return np.concatenate(rows, axis=0), np.concatenate(tgts, axis=0)


def _butter_highpass_sos(order: int, fc: float, sample_rate: float):
    """Butterworth highpass as second-order sections (cascaded biquads
    are stable in float32, where one direct form of order 6 is not)."""
    from scipy import signal
    return signal.butter(order, fc / sample_rate * 2, btype="highpass",
                         output="sos")


def _sosfilt(sos: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    for section in sos:
        x = lfilter(section[:3], section[3:], x)
    return x


def _log_2cosh(z: torch.Tensor) -> torch.Tensor:
    """log(2 cosh(z)) without overflow: |z| + log1p(exp(-2|z|))."""
    az = torch.abs(z)
    return az + torch.log1p(torch.exp(-2.0 * az))


def _fftfilt(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Overlap-free FFT convolution keeping the first ``x.shape[-1]``
    samples (MATLAB fftfilt semantics)."""
    nb = b.shape[-1]
    nx = x.shape[-1]
    n = 1 << int(np.ceil(np.log2(max(nb + nx - 1, 1))))
    B = torch.fft.rfft(b, n=n)
    X = torch.fft.rfft(x, n=n)
    return torch.fft.irfft(X * B, n=n)[..., :nx]


def _interp1_uniform(x0: float, step: float, y: torch.Tensor,
                     xq: torch.Tensor) -> torch.Tensor:
    """Linear interpolation on a uniform grid with linear extrapolation
    (MATLAB's '*linear'); y is 1-D design data, xq is batched."""
    z = (xq - x0) / step
    idx = torch.clamp(torch.floor(z).long(), 0, y.shape[-1] - 2)
    frac = z - idx
    return y[idx] * (1.0 - frac) + y[idx + 1] * frac


class SpectrumExtractionBySTRAIGHT(nn.Module):
    """STRAIGHT spectral envelope; returns the log power spectrum.
    Gradients flow through the waveform, not F0."""

    def __init__(self, frame_period: int, sample_rate: int, fft_length: int,
                 *, default_f0: float = 160, spectral_exponent: float = 0.6,
                 compensation_factor: float = 0.2, ovc=None, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.fft_length = fft_length
        self.default_f0 = default_f0
        self.pc = spectral_exponent
        self.mag = compensation_factor

        # Band-split highpass filters: 70 / 300 / 3000 Hz, order 6.
        self.sos = [_butter_highpass_sos(6, fc, sample_rate)
                    for fc in (70.0, 300.0, 3000.0)]

        frame_length = sample_rate * 80 // 1000
        if fft_length < frame_length:
            raise ValueError(f"fft_length must be at least {frame_length}.")
        self.frame_length = frame_length

        # Pitch-synchronous Gaussian-Bartlett window seed.
        tt = (np.arange(frame_length) + (1 - frame_length / 2)) / sample_rate
        self.fNominal = 40.0
        eta = 1.0
        wGaussian = np.exp(-np.pi * (tt * self.fNominal / eta) ** 2)
        wBartlett = 1.0 - np.abs(tt * self.fNominal)
        support = wBartlett[wBartlett > 0]
        wPSGSeed = np.convolve(np.concatenate([wGaussian,
                                               np.zeros(frame_length)]),
                               support)[: 2 * frame_length]
        max_loc = int(np.argmax(wPSGSeed))
        wPSGSeed = wPSGSeed / wPSGSeed[max_loc]
        # Uniform nominal-time grid for '*linear' interpolation.
        self.tN0 = (0 - max_loc) / sample_rate
        self.tNstep = 1.0 / sample_rate

        one_sided = fft_length // 2 + 1
        remaining = fft_length - one_sided
        ttm = np.concatenate([np.arange(one_sided),
                              np.arange(remaining) - remaining]) / sample_rate
        ttm[0] = 1e-5 / sample_rate

        ramp = np.arange(fft_length)
        lft = 1.0 / (1.0 + np.exp(-(np.abs(ramp - fft_length // 2)
                                    - fft_length / 30) / 2))

        self.ovc = np.asarray(optimum_smoothing(eta, self.pc)
                              if ovc is None else ovc, np.float64)

        # Unvoiced power-tracking smoother.
        ncw = round(2 * sample_rate / 1000)
        h3 = np.convolve(np.hanning(ncw // 2 + 2)[1:-1],
                         np.exp(-1400 / sample_rate
                                * np.arange(2 * ncw + 1)))

        ipwm = 7
        ipl = round(ipwm / (frame_period / sample_rate * 1000))
        ww = np.hanning(ipl * 2 + 3)[1:-1]

        hh = np.array([[1, 1, 1, 1],
                       [0, 1 / 2, 2 / 3, 3 / 4],
                       [0, 0, 1 / 3, 2 / 4],
                       [0, 0, 0, 1 / 4]])
        bb = np.linalg.solve(hh, self.ovc)
        cc = np.array([1.0, 4.0, 9.0, 16.0])
        tq = np.arange(one_sided) / sample_rate
        pb2 = (np.pi / eta**2 + np.pi**2 / 3 * np.sum(bb * cc)) * tq**2

        for name, value in (("wPSGSeed", wPSGSeed), ("tt", tt),
                            ("ttm", ttm), ("lft", lft), ("h3", h3),
                            ("ww", ww / ww.sum()), ("pb2", pb2)):
            self.register_buffer(name, torch.as_tensor(value))
        place(self, device, dtype)

    def forward(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        eps = 1e-8
        L = self.fft_length
        one_sided = L // 2 + 1
        sr = self.sample_rate

        xamp = torch.std(x, dim=-1, keepdim=True, correction=0)
        scaleconst = 2200.0
        x = torch.where(xamp < eps, x, x * (scaleconst / (xamp + eps)))
        xh = torch.stack([_sosfilt(sos, x) for sos in self.sos], dim=-2)

        f0 = f0.detach()[..., None]
        f0raw = f0
        unvoiced = f0 == 0
        f0 = torch.where(unvoiced, torch.full_like(f0, self.default_f0), f0)
        nframe = f0.shape[-2]

        # row count follows the f0 track (world_common.frames_matching_f0)
        tx = frames_matching_f0(xh[..., 0, :], nframe, self.frame_length,
                                self.frame_period, mode="constant",
                                zmean=True)
        ttf = self.tt * f0                                  # (..., N, Lf)

        def safe_div(a, b):
            return a / (b + eps)

        wxe = _interp1_uniform(self.tN0, self.tNstep, self.wPSGSeed,
                               ttf / self.fNominal)
        wxe = safe_div(wxe, torch.linalg.vector_norm(wxe, dim=-1,
                                                     keepdim=True))
        wxd = 0.36 * wxe * torch.sin(np.pi * ttf)

        pw = (torch.abs(torch.fft.rfft(tx * wxe, n=L)) ** 2
              + torch.abs(torch.fft.rfft(tx * wxd, n=L)) ** 2)
        pw = torch.clamp(pw, min=eps) ** (self.pc / 2)

        # Low-band symmetrization below half the fundamental.
        ramp1 = torch.arange(one_sided, dtype=pw.dtype, device=pw.device)
        f0pr = f0 * (L / sr) + 1
        f0p2 = torch.floor((f0pr + 1) / 2)
        pwxq = f0pr - ramp1                                  # (..., N, K)
        zq = torch.clamp(pwxq - 1.0, 0.0, one_sided - 1.0)
        iq = torch.clamp(torch.floor(zq).long(), 0, one_sided - 2)
        fq = zq - iq
        tmppw = (torch.gather(pw, -1, iq) * (1 - fq)
                 + torch.gather(pw, -1, iq + 1) * fq)
        pw = torch.where(ramp1 < f0p2, tmppw, pw)

        # Two-stage pitch-adaptive smoothing.
        ttmf = self.ttm * f0                                 # (..., N, L)
        ww2t = torch.sinc(3 * ttmf) ** 2
        spw2 = torch.fft.ihfft(ww2t * torch.fft.hfft(pw) * self.lft).real
        ovc = [float(v) for v in self.ovc]
        wwt = torch.sinc(ttmf) ** 2
        wwt = wwt * (ovc[0] + ovc[1] * 2 * torch.cos(TAU * ttmf)
                     + ovc[2] * 2 * torch.cos(2 * TAU * ttmf))
        spw = safe_div(
            torch.fft.ihfft(wwt * torch.fft.hfft(safe_div(pw, spw2))
                            * self.lft).real,
            wwt[..., :1])
        spw = torch.clamp(spw, -100.0, 100.0)
        n2sgram = spw2 * (0.175 * _log_2cosh(4 / 1.4 * spw) + 0.5 * spw)
        n2sgram = torch.clamp(n2sgram, min=eps) ** (2 / self.pc)

        # Unvoiced-frame power tracking.
        h3n = self.h3.shape[-1]
        pwcs = _fftfilt(self.h3, torch.nn.functional.pad(
            torch.abs(xh[..., 1:, :]) ** 2, (0, 4 * h3n)))
        end = self.frame_period * nframe
        pwcs = pwcs[..., :end:self.frame_period]
        lbb = round(300 / sr * L) - 1
        numer = torch.cat(
            [torch.sum(n2sgram[..., lbb:], dim=(-1, -2), keepdim=True),
             torch.sum(n2sgram, dim=(-1, -2), keepdim=True)], dim=-2)
        denom = torch.sum(pwcs, dim=-1, keepdim=True)
        pwcs = pwcs * safe_div(numer, denom)
        pwch = pwcs[..., 1, :]

        wwn = self.ww.shape[-1]
        begin = wwn // 2
        apwt = _fftfilt(self.ww, torch.nn.functional.pad(pwch, (0, wwn)))
        apwt = apwt[..., begin:begin + nframe]
        mmaa = torch.amax(apwt, dim=-1, keepdim=True)
        apwt = torch.where(apwt <= 0, mmaa, apwt)

        dpwt = _fftfilt(self.ww, torch.nn.functional.pad(
            torch.diff(pwch, dim=-1) ** 2, (0, wwn + 1)))
        # FFT convolution of nonnegative data can round to tiny negatives
        # at float32; the true value is >= 0, so clamp before the sqrt.
        dpwt = torch.sqrt(torch.clamp(dpwt[..., begin:begin + nframe],
                                      min=0.0) + eps)
        rr = torch.clamp(safe_div(dpwt, apwt), min=0.0)
        lmbd = torch.sigmoid((torch.sqrt(rr) - 0.75) * 20)

        pwc = (lmbd * safe_div(pwcs[..., 0, :], torch.sum(n2sgram, dim=-1))
               + (1 - lmbd))
        n2sgram = torch.where(unvoiced, n2sgram * pwc[..., None], n2sgram)
        n2sgram = torch.sqrt(torch.abs(n2sgram + eps))

        # Spectral recovery from over-smoothing.
        if 0 < self.mag:
            ccs2 = (torch.fft.hfft(n2sgram)[..., :one_sided]
                    * torch.clamp(1 + self.mag * self.pb2 * f0raw**2,
                                  max=20.0))
            n2sgram3 = torch.fft.hfft(ccs2, norm="forward")[..., :one_sided]
            n2sgram = (torch.abs(n2sgram3) + n2sgram3) / 2 + 0.1

        xamp = xamp[..., None]
        n3sgram = torch.where(xamp < eps, n2sgram,
                              n2sgram * (xamp / scaleconst))
        return 2 * torch.log(torch.abs(n3sgram + eps))
