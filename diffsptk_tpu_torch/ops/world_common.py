"""Shared WORLD vocoder math (counterpart of
``diffsptk_tpu/ops/world_common.py``).

Static shapes throughout: every f0-adaptive window or smoother is a dense
masked read.  The per-frame windowed reads run through the windowed-gather
kernel (kernels/gather.py).  The JAX package's TPU workarounds take their
plain GPU form here: frames are ``unfold`` views, the spectrum's cumsum is
``torch.cumsum``, transforms are ``torch.fft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import threefry
from ..kernels.gather import gather_windows
from ..utils import prng

TAU = 2 * np.pi


def interp1(x, y, xq, method: str = "linear", batching=(False, False)):
    """Piecewise-linear interpolation with constant extrapolation
    (``method="linear"``) or linear extrapolation (``"*linear"``)."""
    if not batching[0]:
        x = torch.broadcast_to(x, xq.shape[:-1] + x.shape[-1:])
    if not batching[1]:
        y = torch.broadcast_to(y, xq.shape[:-1] + y.shape[-1:])
    m = torch.diff(y, dim=-1) / torch.diff(x, dim=-1)
    b = y[..., :-1] - m * x[..., :-1]
    indices = torch.searchsorted(x.contiguous(), xq.contiguous())
    if method == "linear":
        m = F.pad(m, (1, 1))
        b = torch.cat([y[..., :1], b, y[..., -1:]], dim=-1)
    elif method == "*linear":
        indices = torch.clamp(indices - 1, 0, m.shape[-1] - 1)
    else:
        raise ValueError(f"Unknown method: {method}")
    return torch.gather(m, -1, indices) * xq + torch.gather(b, -1, indices)


def interp1Q(x, shift, y, xi):
    """Quantized linear interpolation: sample y (uniform grid starting at x
    with step ``shift``) at positions xi."""
    z = (xi - x) / shift
    base = torch.clamp(z.to(torch.int32), 0, y.shape[-1] - 1).long()
    frac = z - base
    delta = torch.diff(y, dim=-1, append=y[..., -1:])
    return torch.gather(y, -1, base) + torch.gather(delta, -1, base) * frac


def _frame_windows(rows: torch.Tensor, starts: torch.Tensor, length: int,
                   guard: int) -> torch.Tensor:
    """Per-frame windowed reads rows[..., n, starts[..., n] + k].

    Flattens the frame axis into one guarded signal per batch row for the
    windowed gather; starts must satisfy 0 <= start and
    start + length <= row_len + guard (the guard region reads zeros)."""
    lead = rows.shape[:-2]
    n, d = rows.shape[-2], rows.shape[-1]
    stride = d + guard
    flat = F.pad(rows, (0, guard)).reshape(-1, n * stride)
    off = torch.arange(n, device=rows.device) * stride
    st = (starts.long() + off).reshape(-1, n)
    return gather_windows(flat, st, length).reshape(lead + (n, length))


def dc_correction(power_spectrum, f0, sample_rate, fft_length, ramp,
                  max_bins: int | None = None):
    """Reflect sub-f0 spectrum mass around f0 (WORLD DCCorrection).

    corrected[k] = (1-f) ps[b0-k] + f ps[b0+1-k] is a per-frame shifted
    window of the flipped spectrum: one windowed gather.  ``max_bins``
    bounds f0/rate + 2 (defaults to the full half-spectrum).
    """
    rate = sample_rate / fft_length
    D = fft_length // 2 + 1
    low_axis = ramp[:D] * rate
    mask = low_axis < f0

    c = f0 / rate                                   # (..., 1)
    b0 = torch.clamp(torch.floor(c), 0, D - 2)
    f = c - b0
    Lh = D if max_bins is None else min(max_bins, D)

    # W[j] = psrev[(D-2-b0) + j] = ps[b0+1-j]; reads with b0+1-j < 0 land
    # in the zero guard.
    psrev = torch.flip(power_spectrum, (-1,))
    starts = (D - 2 - b0[..., 0]).long()
    W = _frame_windows(psrev, starts, Lh + 1, guard=Lh + 2)
    corrected = f * W[..., :Lh] + (1 - f) * W[..., 1:Lh + 1]
    if Lh < D:
        corrected = F.pad(corrected, (0, D - Lh))
    return power_spectrum + corrected * mask


def get_minimum_phase_spectrum(spectrum):
    """Minimum-phase complex spectrum of a (..., L) power spectrum."""
    L = spectrum.shape[-1]
    nfft = 2 * (L - 1)
    cepstrum = torch.fft.irfft(0.5 * torch.log(spectrum), n=nfft)
    cepstrum = torch.cat(
        (cepstrum[..., :1], 2 * cepstrum[..., 1:L - 1],
         cepstrum[..., L - 1:L]), dim=-1)
    C = torch.fft.rfft(cepstrum, n=nfft)
    return torch.exp(C.real) * torch.exp(1j * C.imag)


@functools.lru_cache(maxsize=None)
def minimum_phase_plans(nfft: int):
    """Static plans for the minimum-phase construction, float64 numpy.

    C = u + i H(u) with u = 0.5 log(spectrum): the imaginary part is the
    discrete Hilbert transform of u, a (K, K) matrix.  The synthesis's
    inverse transform with fftshift and the * nfft scale is a (K, nfft)
    pair.  Returns (H, IRe, IIm): angle = u @ H;
    out[t] = sum_k Re[k] IRe[k,t] + Im[k] IIm[k,t].
    """
    if nfft % 2 != 0:
        raise ValueError("minimum_phase_plans requires an even fft length.")
    K = nfft // 2 + 1
    t = np.arange(nfft)
    k = np.arange(K)
    w = np.full(K, 2.0)
    w[0] = w[-1] = 1.0
    cos_kt = np.cos(2.0 * np.pi * np.outer(k, t) / nfft)    # (K, nfft)
    A = (w[:, None] * cos_kt) / nfft                        # u -> cep
    fold = np.full(nfft, 0.0)
    fold[0] = 1.0
    fold[1:K - 1] = 2.0
    fold[K - 1] = 1.0
    sin_tk = -np.sin(2.0 * np.pi * np.outer(t, k) / nfft)   # (nfft, K)
    H = A @ (fold[:, None] * sin_tk)                        # (K, K)
    sh = t + nfft // 2
    IRe = w[:, None] * np.cos(2.0 * np.pi * np.outer(k, sh) / nfft)
    IIm = -w[:, None] * np.sin(2.0 * np.pi * np.outer(k, sh) / nfft)
    return H, IRe, IIm


@functools.lru_cache(maxsize=None)
def synthesis_response_plans(nfft: int):
    """One folded (4K, nfft) plan for the whole per-pulse response.

    The response is linear in the four spectra (Re/Im of the periodic and
    aperiodic minimum-phase constructions), and so is every step after
    the inverse transform: zeroing the periodic response's acausal half
    and subtracting its DC through the rank-1 DC remover.  All of it folds
    into one static matrix.  Returns (H, P_fold) float64, P_fold rows
    [IRe_p; IIm_p; IRe; IIm].
    """
    H, IRe, IIm = minimum_phase_plans(nfft)
    half = nfft // 2
    r = np.arange(1, half + 1)
    dc = 0.5 - 0.5 * np.cos(TAU / (1 + nfft) * r)
    dc = dc / (2 * np.sum(dc))
    dc_remover = np.concatenate([dc, dc[::-1]])
    mask = np.zeros(nfft)
    mask[half:] = 1.0
    sRe = np.sum(IRe[:, half:], axis=1)       # DC of the causal half
    sIm = np.sum(IIm[:, half:], axis=1)
    IRe_p = IRe * mask - np.outer(sRe, dc_remover)
    IIm_p = IIm * mask - np.outer(sIm, dc_remover)
    return H, np.vstack([IRe_p, IIm_p, IRe, IIm])


@functools.lru_cache(maxsize=None)
def noise_dft_plans(n_in: int, nfft: int):
    """Real-DFT plan pair (cos, -sin), (n_in, K) each, for a length
    ``n_in`` real signal zero-padded to ``nfft``."""
    K = nfft // 2 + 1
    t = np.arange(n_in)
    k = np.arange(K)
    arg = 2.0 * np.pi * np.outer(t, k) / nfft
    return np.cos(arg), -np.sin(arg)


def frames_matching_f0(x, n_frames, frame_length, frame_period,
                       mode="replicate", zmean=False):
    """Centered, edge-padded frames of x, exactly ``n_frames`` rows: frame
    n covers padded samples [n P, n P + L) (one per f0 frame, T // P + 1
    of them, where Frame gives (T - 1) // P + 1)."""
    L, P = frame_length, frame_period
    T = x.shape[-1]
    K = -(-L // P)
    total = (n_frames + K) * P
    right = max(total - L // 2 - T, 0)
    shape = x.shape
    xp = F.pad(x.reshape(-1, 1, T), (L // 2, right), mode=mode)
    xp = xp.reshape(shape[:-1] + (xp.shape[-1],))[..., :total]
    y = xp.unfold(-1, L, P)[..., :n_frames, :]
    if zmean:
        y = y - torch.mean(y, dim=-1, keepdim=True)
    return y


def dither_noise(shape, dtype, device) -> torch.Tensor:
    """The dither of the windowed waveform: standard normal under
    PRNGKey(0) in every call, JAX's stream (the threefry kernel on the
    card in float32, kernels/threefry.py), so the port dithers with the
    JAX package's numbers."""
    return threefry.normal(prng.PRNGKey(0), shape, dtype, device)


def get_windowed_waveform(x, f0, window_length_ratio, bias_ratio,
                          frame_period, sample_rate, fft_length, window_type,
                          normalize_window, eps, ramp, frames=None):
    half_window_length = torch.round(
        window_length_ratio / 2 * sample_rate / f0)
    bias = torch.round(bias_ratio * sample_rate / f0)
    base_index = ramp[:fft_length] - bias - fft_length // 2
    position = base_index / (window_length_ratio / 2 * sample_rate)
    z = np.pi * position * f0
    if window_type == "hanning":
        window = 0.5 + 0.5 * torch.cos(z)
    elif window_type == "blackman":
        window = 0.42 + 0.5 * torch.cos(z) + 0.08 * torch.cos(2 * z)
    else:
        raise RuntimeError
    mask = (-half_window_length <= base_index) & (base_index
                                                  <= half_window_length)
    window = window * mask
    if normalize_window:
        window = window / torch.linalg.vector_norm(window, dim=-1,
                                                   keepdim=True)

    if frames is None:
        frames = frames_matching_f0(x, window.shape[-2], fft_length,
                                    frame_period)
    waveform = frames * window
    if eps > 0:
        waveform = waveform + (dither_noise(waveform.shape, waveform.dtype,
                                            waveform.device) * eps * mask)
    w1 = torch.sum(waveform, dim=-1, keepdim=True)
    w2 = torch.sum(window, dim=-1, keepdim=True)
    return waveform - window * (w1 / w2)


def linear_smoothing(power_spectrum, width, sample_rate, fft_length, ramp,
                     max_boundary: int):
    """Rectangular smoothing of the power spectrum with per-frame width.

    ``max_boundary`` bounds width/rate + 1 (a fixed mirror size).  The
    smoothed value is the difference of two lerped reads of the running
    sum of the mirrored spectrum at per-frame offsets: two windowed
    gathers.  The running sum is taken in float64 and, for a float32
    spectrum, read as a float32 pair (hi, lo) whose differences are taken
    part by part: a float32 running sum of a spectrum with a 100 dB range
    loses the small windowed sums under its rounding (D4C's aperiodicity
    then moves by up to 0.8).
    """
    one_sided = fft_length // 2 + 1
    rate = sample_rate / fft_length
    boundary = (width / rate).to(torch.int32) + 1
    mb = max_boundary
    shape = power_spectrum.shape
    mirror = F.pad(power_spectrum.reshape(-1, 1, shape[-1]), (mb, mb),
                   mode="reflect").reshape(shape[:-1] + (shape[-1] + 2 * mb,))
    bias = mb - boundary
    mask = bias <= ramp[:mb]
    mask = torch.cat(
        [mask, mask.new_ones(mask.shape[:-1] + (one_sided + mb,))], dim=-1)
    mirror = mirror * mask

    segment = torch.cumsum((mirror * rate).double(), dim=-1)
    hi = segment.to(mirror.dtype)
    parts = [hi]
    if mirror.dtype != torch.float64:
        parts.append((segment - hi.double()).to(mirror.dtype))
    # Reads past the segment end see its final value (the increments
    # beyond the mirror are zero).
    tail = 2 * mb + 4
    seg_ext = torch.stack(
        [torch.cat([p, p[..., -1:].expand(p.shape[:-1] + (tail,))], dim=-1)
         for p in parts])                               # (parts, ..., N, L)

    Ls = mirror.shape[-1]
    c1 = mb - 0.5 - width / (2 * rate)
    c2 = mb - 0.5 + width / (2 * rate)
    lim = min(Ls - 2, 2 * mb)
    b1 = torch.clamp(torch.floor(c1), 0, lim)
    b2 = torch.clamp(torch.floor(c2), 0, lim)
    f1 = c1 - b1
    f2 = c2 - b2
    WL = one_sided + 1
    lead = seg_ext.shape[:-1]
    W1 = _frame_windows(seg_ext, b1[..., 0].long().expand(lead), WL, guard=4)
    W2 = _frame_windows(seg_ext, b2[..., 0].long().expand(lead), WL, guard=4)
    # high - low = H[k2] - L[k1] + f2 (H[k2+1] - H[k2]) - f1 (L[k1+1] -
    # L[k1]): the large terms cancel first, part by part.
    n = one_sided
    d0 = (W2[..., :n] - W1[..., :n]).sum(0)
    dH = (W2[..., 1:] - W2[..., :n]).sum(0)
    dL = (W1[..., 1:] - W1[..., :n]).sum(0)
    return (d0 + f2 * dH - f1 * dL) / width
