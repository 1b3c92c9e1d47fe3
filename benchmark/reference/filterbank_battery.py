"""Plain reference of the filterbank battery: CQT -> ICQT, MDCT -> IMDCT
and PQMF -> IPQMF, summed (BASELINE.json configs[4]).

It imports nothing of the program.  The designs are frozen copies of the
numpy design code of ``diffsptk_tpu_torch`` at commit 2f79b3d, named
above each; the transforms are written out plainly (one strided
``conv1d`` for every resampler, real matmuls for the complex basis
products, one ``conv_transpose1d`` overlap-add an octave), so that the
precision of ``arith`` (``harness/compare.py``) reaches every product.

The battery is computed on a segment of the global signal.  Every stage
is a finite-support linear map, so outputs far enough from the segment's
edges (``MARGIN`` samples) equal those of the whole signal, when the
segment starts on a multiple of ``ALIGN`` samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ALIGN = 128
"""A segment starts on a multiple of every frame period and decimation."""

MARGIN = 295_168 + 32_768
"""Samples on each side of a segment whose outputs are not compared: the
sharded CQT's halo (its receptive field and the resamplers' margins)
and, for the ICQT, more than its frames' reach (264 frames of 64) and
its upsamplers'."""


# diffsptk_tpu_torch/ops/cqt_design.py
def _window(name: str, n: int) -> np.ndarray:
    if name in ("hann", "hanning"):
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))
    if name in ("rectangular", "boxcar", "ones"):
        return np.ones(n)
    raise ValueError(f"window {name} is not supported here")


def _window_bandwidth(name: str, n: int = 1000) -> float:
    w = _window(name, n)
    return n * np.sum(w ** 2) / (np.sum(w) ** 2 + np.finfo(np.float64).tiny)


def _relative_bandwidth(freqs: np.ndarray) -> np.ndarray:
    bpo = np.empty_like(freqs)
    logf = np.log2(freqs)
    bpo[0] = 1 / (logf[1] - logf[0])
    bpo[-1] = 1 / (logf[-1] - logf[-2])
    bpo[1:-1] = 2 / (logf[2:] - logf[:-2])
    return (2.0 ** (2 / bpo) - 1) / (2.0 ** (2 / bpo) + 1)


def _wavelet_lengths(freqs, sr, window, filter_scale, alpha):
    Q = float(filter_scale) / alpha
    f_cutoff = float(np.max(freqs * (1 + 0.5 * _window_bandwidth(window)
                                     / Q)))
    return Q * sr / freqs, f_cutoff


def _wavelet(freqs, sr, window, filter_scale, norm, alpha):
    lengths, _ = _wavelet_lengths(freqs, sr, window, filter_scale, alpha)
    filters = []
    for ilen, freq in zip(lengths, freqs):
        t = np.arange(-ilen // 2, ilen // 2, dtype=float) * 2 * np.pi \
            * freq / sr
        sig = (np.cos(t) + 1j * np.sin(t)) * _window(window, len(t))
        mag = np.sum(np.abs(sig) ** norm) ** (1.0 / norm)
        filters.append(sig / max(mag, np.finfo(np.float64).tiny))
    max_len = int(2.0 ** np.ceil(np.log2(max(lengths))))
    basis = np.zeros((len(filters), max_len), dtype=np.complex128)
    for i, f in enumerate(filters):
        lpad = (max_len - len(f)) // 2
        basis[i, lpad:lpad + len(f)] = f
    return basis, lengths


def _sparsify_rows(x: np.ndarray, quantile: float) -> np.ndarray:
    mags = np.abs(x)
    norms = np.sum(mags, axis=1, keepdims=True)
    mag_sort = np.sort(mags, axis=1)
    cumulative = np.cumsum(mag_sort / norms, axis=1)
    threshold_idx = np.argmin(cumulative < quantile, axis=1)
    out = np.zeros_like(x)
    for i, j in enumerate(threshold_idx):
        keep = mags[i] >= mag_sort[i, j]
        out[i, keep] = x[i, keep]
    return out


def _filter_fft(sr, freqs, filter_scale, norm, sparsity, window, alpha,
                force_n_fft=None):
    basis, lengths = _wavelet(freqs, sr, window, filter_scale, norm, alpha)
    n_fft = basis.shape[1]
    full = np.fft.fft(basis * (lengths[:, None] / float(n_fft)), n=n_fft,
                      axis=1)
    half = _sparsify_rows(full[:, :n_fft // 2 + 1], sparsity)
    half = half.astype(np.complex64).astype(np.complex128)
    if force_n_fft is None or force_n_fft == n_fft:
        return half, n_fft
    spec = full.copy()
    spec[:, :n_fft // 2 + 1] = np.where(half != 0, full[:, :n_fft // 2 + 1],
                                        0.0)
    wav = np.fft.ifft(spec, axis=1)
    pad = force_n_fft - n_fft
    wav = np.pad(wav, ((0, 0), (pad // 2, pad - pad // 2)))
    out = np.fft.fft(wav, n=force_n_fft, axis=1)[:, :force_n_fft // 2 + 1]
    return out * (n_fft / force_n_fft), force_n_fft


def _two_factors(x: int) -> int:
    n = 0
    while x > 0 and x % 2 == 0:
        n, x = n + 1, x // 2
    return n


# diffsptk_tpu_torch/utils/resample.py:design_resample_kernel
# ("kaiser_best")
def resample_kernel(orig: int, new: int, width: int = 64,
                    rolloff: float = 0.9475937167399596,
                    beta: float = 14.769656459379492):
    """(new, K) polyphase taps, the left pad, and the reduced ratio."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    pad = int(math.ceil(width * orig / base))
    idx = np.arange(-pad, pad + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width, width)
    win = np.i0(beta * np.sqrt(np.maximum(1 - (t / width) ** 2, 0.0))) \
        / np.i0(beta)
    t = t * np.pi
    kern = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    return kern * win * base / orig, pad, orig, new


# diffsptk_tpu_torch/ops/cqt.py:ConstantQTransform and
# InverseConstantQTransform (f_min 32.7, 12 bins an octave, hann, norm 1,
# sparsity 1e-2, scale, kaiser_best)
def cqt_design(frame_period: int, sample_rate: int, n_bin: int,
               f_min: float = 32.7, per_octave: int = 12) -> dict:
    K, B = n_bin, per_octave
    n_oct = int(np.ceil(K / B))
    freqs = f_min * 2.0 ** (np.arange(K, dtype=float) / B)
    alpha = _relative_bandwidth(freqs)
    lengths, cutoff = _wavelet_lengths(freqs, sample_rate, "hann", 1, alpha)
    c1 = max(0, int(np.ceil(np.log2(sample_rate * 0.5 / cutoff)) - 1) - 1)
    c2 = max(0, _two_factors(frame_period) - n_oct + 1)
    early = 2 ** min(c1, c2) if min(c1, c2) > 0 else 1
    fp, sr = frame_period // early, sample_rate / early
    fwd_lengths = (_wavelet_lengths(freqs, sr, "hann", 1, alpha)[0]
                   if early > 1 else lengths)
    fps, srs = [fp], [sr]
    for i in range(n_oct - 1):
        even = fps[i] % 2 == 0
        fps.append(fps[i] // 2 if even else fps[i])
        srs.append(srs[i] * 0.5 if even else srs[i])

    def bases(order):
        slices = [slice(B * i, B * i + min(B, K - B * i)) for i in order]
        nat = [_filter_fft(srs[o], freqs[sl], 1, 1, 1e-2, "hann", alpha[sl])
               for o, sl in zip(range(n_oct), slices)]
        n_fft = max(n for _, n in nat)
        out = [b if n == n_fft else _filter_fft(
            srs[o], freqs[sl], 1, 1, 1e-2, "hann", alpha[sl], n_fft)[0]
            for o, sl, (b, n) in zip(range(n_oct), slices, nat)]
        return out, n_fft, slices

    # forward: octave o (top first) holds bins [K - B (o+1), K - B o)
    fwd, n_fft, _ = bases([n_oct - 1 - o for o in range(n_oct)])
    fwd = [(b * np.sqrt(sample_rate / early / srs[o])).T
           for o, b in enumerate(fwd)]
    # inverse: octaves low to high, at the reversed rates of the original
    # frame period and sample rate (the inverse has no early downsample)
    inv_fp, inv_sr = [frame_period], [float(sample_rate)]
    for i in range(n_oct - 1):
        even = inv_fp[i] % 2 == 0
        inv_fp.append(inv_fp[i] // 2 if even else inv_fp[i])
        inv_sr.append(inv_sr[i] * 0.5 if even else inv_sr[i])
    inv_fp, inv_sr = inv_fp[::-1], inv_sr[::-1]
    inv = []
    for i in range(n_oct):
        sl = slice(B * i, B * i + min(B, K - B * i))
        b, n_inv = _filter_fft(inv_sr[i], freqs[sl], 1, 1, 1e-2, "hann",
                               alpha[sl])
        inv.append((sl, b, n_inv))
    n_inv = max(n for *_, n in inv)
    time_bases = []
    for i, (sl, b, n) in enumerate(inv):
        if n != n_inv:
            b = _filter_fft(inv_sr[i], freqs[sl], 1, 1, 1e-2, "hann",
                            alpha[sl], n_inv)[0]
        b = np.conj(b)
        power = 1.0 / np.sum(np.abs(b) ** 2, axis=1) * n_inv / lengths[sl]
        b = b * power[:, None]
        tb = np.concatenate([np.fft.irfft(b, n=n_inv),
                             np.fft.irfft(1j * b, n=n_inv)])
        time_bases.append(tb * np.tile(np.sqrt(lengths[sl]), 2)[:, None])
    return {"early": early, "early_scale": float(np.sqrt(early)),
            "fps": fps, "fwd": fwd, "n_fft": n_fft,
            "scale": 1.0 / np.sqrt(fwd_lengths), "n_bin": K,
            "per_octave": B, "inv_hops": inv_fp,
            "inv_up": [int(sample_rate // s) for s in inv_sr],
            "time_bases": time_bases}


def _t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                           device=like.device)


def resample(x: torch.Tensor, orig: int, new: int, arith) -> torch.Tensor:
    """(rows, T) -> (rows, ceil(T new / orig)): every output phase p of
    input frame n is sum_k xpad[n orig + k] kern[p, k]."""
    kern, pad, orig, new = resample_kernel(orig, new)
    if orig == new:
        return x
    T = x.shape[-1]
    xp = F.pad(x, (pad, pad + orig))[:, None, :]
    y = arith.conv1d(xp, _t(kern[:, None, :], x), stride=orig)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    return y[..., :-(-new * T // orig)]


def _cmm(re, im, basis, arith):
    bre, bim = basis.real, basis.imag
    return (arith.mm(re, _t(bre, re)) - arith.mm(im, _t(bim, re)),
            arith.mm(re, _t(bim, re)) + arith.mm(im, _t(bre, re)))


def cqt(x: torch.Tensor, d: dict, arith):
    """(rows, T) -> (Re, Im) of (rows, T / frame period + 1, n_bin)."""
    if d["early"] > 1:
        x = resample(x, d["early"], 1, arith) * d["early_scale"]
    L = d["n_fft"]
    res = []
    for o, fp in enumerate(d["fps"]):
        frames = F.pad(x, (L // 2, (L - 1) // 2)).unfold(-1, L, fp)
        spec = torch.fft.rfft(frames, n=L)
        res.append(_cmm(spec.real, spec.imag, d["fwd"][o], arith))
        if o < len(d["fps"]) - 1 and fp % 2 == 0:
            x = resample(x, 2, 1, arith) * math.sqrt(2)
    n = min(r[0].shape[-2] for r in res)
    K, B = d["n_bin"], d["per_octave"]
    keep = [min(B, K - B * (len(res) - 1 - o)) for o in range(len(res))]
    re = torch.cat([r[0][..., :n, -k:] for r, k in zip(res, keep)][::-1],
                   dim=-1)
    im = torch.cat([r[1][..., :n, -k:] for r, k in zip(res, keep)][::-1],
                   dim=-1)
    s = _t(d["scale"], x)
    return re * s, im * s


def icqt(re: torch.Tensor, im: torch.Tensor, d: dict, out_length: int,
         arith) -> torch.Tensor:
    """(Re, Im) of (rows, N, n_bin) -> (rows, out_length)."""
    y = None
    B = d["per_octave"]
    for i, (hop, up, tb) in enumerate(zip(d["inv_hops"], d["inv_up"],
                                          d["time_bases"])):
        sl = slice(B * i, B * (i + 1))
        a = torch.cat([re[..., sl], im[..., sl]], dim=-1)   # (rows, N, 2K)
        N, L = a.shape[-2], tb.shape[-1]
        num = arith.conv_transpose1d(a.transpose(1, 2),
                                     _t(tb[:, None, :], a), stride=hop)[:, 0]
        t = torch.arange(num.shape[-1], device=a.device)
        last = torch.clamp(torch.div(t, hop, rounding_mode="floor"),
                           max=N - 1)
        first = torch.clamp(-torch.div(L - 1 - t, hop, rounding_mode="floor"),
                            min=0)
        xi = num / ((last - first + 1).to(num.dtype) + 1e-16)
        xi = resample(xi[..., L // 2:L // 2 + N * hop], 1, up, arith)
        if y is None:
            y = xi[..., :out_length]
        else:
            end = min(xi.shape[-1], y.shape[-1])
            y = torch.cat([y[..., :end] + xi[..., :end], y[..., end:]], -1)
    return y


# diffsptk_tpu_torch/ops/mdct.py (sine window, cosine transform),
# ops/frame.py, ops/unframe.py
def _mdct_basis(L: int) -> np.ndarray:
    P = L // 2
    n = np.arange(L) + 0.5
    k = (np.pi / P) * n[:P]
    return np.sqrt(4.0 / P) * np.cos(k[None, :] * (n + P / 2)[:, None])


def _sine(L: int) -> np.ndarray:
    return np.sin(np.pi * (np.arange(L) + 0.5) / L)


def mdct(x: torch.Tensor, L: int, arith) -> torch.Tensor:
    """(rows, T) -> (rows, T / P + 1, P), P = L / 2."""
    P = L // 2
    xp = F.pad(F.pad(x, (0, P)), (L // 2, (L - 1) // 2))
    frames = xp.unfold(-1, L, P) * _t(_sine(L), x)
    return arith.mm(frames, _t(_mdct_basis(L), x))


def imdct(m: torch.Tensor, L: int, out_length: int, arith) -> torch.Tensor:
    """The sine window once, then an overlap-add normalised by the
    number of frames over each sample (Unframe's rectangular window)."""
    P = L // 2
    frames = arith.mm(m, _t(_mdct_basis(L).T, m)) * _t(_sine(L), m)
    N = frames.shape[-2]
    num = F.fold(frames.transpose(1, 2), (1, (N + 1) * P), (1, L),
                 stride=(1, P))[:, 0, 0]
    den = F.fold(torch.ones_like(frames[:1]).transpose(1, 2),
                 (1, (N + 1) * P), (1, L), stride=(1, P))[:, 0, 0]
    return (num / (den + 1e-16))[..., L // 2:L // 2 + out_length]


# diffsptk_tpu_torch/ops/pqmf.py:make_filter_banks (alpha 100, 100
# iterations, step 1e-2, decay 0.5, eps 1e-6)
def pqmf_filters(n_band: int, order: int, mode: str) -> np.ndarray:
    a = 100.0
    beta = 0.1102 * (a - 8.7)
    w = np.kaiser(order + 1, beta)
    x = np.arange(order + 1) - 0.5 * order
    n_fft = 1 << (order).bit_length()
    index = n_fft // (4 * n_band)
    omega, step, best = np.pi / (2 * n_band), 1e-2, np.inf
    proto = None
    for _ in range(100):
        with np.errstate(invalid="ignore"):
            h = np.sin(omega * x) / (np.pi * x)
        if order % 2 == 0:
            h[order // 2] = omega / np.pi
        proto = h * w
        err = np.abs(np.fft.rfft(proto, n=n_fft)[index]) ** 2 - 0.5
        if abs(err) < 1e-6:
            break
        if abs(err) < best:
            best = abs(err)
        else:
            step *= 0.5
        omega -= np.sign(err) * step
    sign = 1 if mode == "analysis" else -1
    return np.asarray([2 * proto * np.cos((2 * k + 1) * np.pi / (2 * n_band)
                                          * x + (-1) ** k * np.pi / 4 * sign)
                       for k in range(n_band)])


def _delays(order: int, mode: str) -> tuple[int, int]:
    if order % 2 == 0:
        return order // 2, order // 2
    lo, hi = (order + 1) // 2, (order - 1) // 2
    return (lo, hi) if mode == "analysis" else (hi, lo)


def _bank(x: torch.Tensor, filters: torch.Tensor, delay, arith):
    xp = F.pad(x, (delay[0], 0))
    if delay[1] > 0:
        xp = torch.cat([xp, xp[..., -1:].expand(*xp.shape[:-1], delay[1])],
                       dim=-1)
    return arith.conv1d(xp, filters)


def pqmf(x: torch.Tensor, n_band: int, order: int, arith) -> torch.Tensor:
    """(rows, T) -> (rows, n_band, T)."""
    h = pqmf_filters(n_band, order, "analysis")[:, None, ::-1]
    return _bank(x[:, None, :], _t(h, x), _delays(order, "analysis"), arith)


def ipqmf(s: torch.Tensor, n_band: int, order: int, arith) -> torch.Tensor:
    """(rows, n_band, T) -> (rows, T)."""
    h = pqmf_filters(n_band, order, "synthesis")[None, :, ::-1]
    return _bank(s, _t(h, s), _delays(order, "synthesis"), arith)[:, 0]


def battery(config: dict, x: torch.Tensor, arith) -> dict:
    """Every output of the battery on the segment x (rows, T): the CQT
    (complex), the MDCT, the PQMF subbands and the summed waveform."""
    p = config["program"]
    x = x.to(arith.dtype)
    T = x.shape[-1]
    d = cqt_design(p["cqt_frame_period"], config["sample_rate"],
                   p["cqt_n_bin"])
    re, im = cqt(x, d, arith)
    re, im = re[..., :T // p["cqt_frame_period"], :], \
        im[..., :T // p["cqt_frame_period"], :]
    m = mdct(x, p["mdct_frame_length"], arith)
    s = pqmf(x, p["pqmf_n_band"], p["pqmf_order"], arith)
    y = (icqt(re, im, d, T, arith)
         + imdct(m, p["mdct_frame_length"], T, arith)
         + ipqmf(s, p["pqmf_n_band"], p["pqmf_order"], arith)[..., :T])
    return {"cqt": torch.complex(re, im), "mdct": m, "pqmf": s, "y": y}
