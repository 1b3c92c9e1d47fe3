"""Host-side constant-Q/VQT design math (counterpart of
``diffsptk_tpu/ops/cqt_design.py``; standard librosa-style wavelet
construction).

Everything here runs in numpy at design time.  The FFT-domain bases are
kept dense: each octave applies its basis as one small complex matmul.
"""

from __future__ import annotations

import numpy as np

_WINDOW_BANDWIDTHS: dict = {}


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))


def get_window(window: str, n: int) -> np.ndarray:
    if window in ("hann", "hanning"):
        return hann(n)
    if window == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / max(n - 1, 1))
    if window in ("rectangular", "boxcar", "ones"):
        return np.ones(n)
    raise ValueError(f"window {window} is not supported.")


def window_bandwidth(window: str, n: int = 1000) -> float:
    if window not in _WINDOW_BANDWIDTHS:
        w = get_window(window, n)
        _WINDOW_BANDWIDTHS[window] = (
            n * np.sum(w ** 2) / (np.sum(w) ** 2 + np.finfo(np.float64).tiny))
    return _WINDOW_BANDWIDTHS[window]


def cqt_frequencies(n_bins: int, fmin: float, bins_per_octave: int = 12,
                    tuning: float = 0.0) -> np.ndarray:
    """Geometrically spaced center frequencies.

    Examples
    --------
    >>> import numpy as np
    >>> np.round(cqt_frequencies(4, 55.0), 2)
    array([55.  , 58.27, 61.74, 65.41])
    """
    correction = 2.0 ** (float(tuning) / bins_per_octave)
    return correction * fmin * 2.0 ** (np.arange(n_bins, dtype=float)
                                       / bins_per_octave)


def et_relative_bw(bins_per_octave: int) -> np.ndarray:
    r = 2 ** (1 / bins_per_octave)
    return np.atleast_1d((r ** 2 - 1) / (r ** 2 + 1))


def relative_bandwidth(freqs: np.ndarray) -> np.ndarray:
    if len(freqs) <= 1:
        raise ValueError("2 or more frequencies are required.")
    bpo = np.empty_like(freqs)
    logf = np.log2(freqs)
    bpo[0] = 1 / (logf[1] - logf[0])
    bpo[-1] = 1 / (logf[-1] - logf[-2])
    bpo[1:-1] = 2 / (logf[2:] - logf[:-2])
    return (2.0 ** (2 / bpo) - 1) / (2.0 ** (2 / bpo) + 1)


def wavelet_lengths(freqs: np.ndarray, sr: float, window: str = "hann",
                    filter_scale: float = 1, gamma: float | None = 0,
                    alpha=None):
    freqs = np.asarray(freqs)
    if filter_scale <= 0:
        raise ValueError("filter_scale must be positive.")
    if alpha is None:
        alpha = relative_bandwidth(freqs)
    else:
        alpha = np.asarray(alpha)
    gamma_ = alpha * 24.7 / 0.108 if gamma is None else gamma
    Q = float(filter_scale) / alpha
    f_cutoff = float(np.max(freqs * (1 + 0.5 * window_bandwidth(window) / Q)
                            + 0.5 * gamma_))
    lengths = Q * sr / (freqs + gamma_ / alpha)
    return lengths, f_cutoff


def _pad_center(x: np.ndarray, size: int) -> np.ndarray:
    n = len(x)
    lpad = (size - n) // 2
    return np.pad(x, (lpad, size - n - lpad))


def wavelet(freqs: np.ndarray, sr: float, window: str = "hann",
            filter_scale: float = 1, pad_fft: bool = True,
            norm: float | None = 1, gamma: float = 0, alpha=None):
    lengths, _ = wavelet_lengths(freqs, sr, window, filter_scale, gamma,
                                 alpha)
    filters = []
    for ilen, freq in zip(lengths, freqs):
        t = np.arange(-ilen // 2, ilen // 2, dtype=float) \
            * 2 * np.pi * freq / sr
        sig = np.cos(t) + 1j * np.sin(t)
        sig = sig * get_window(window, len(sig))
        if norm is not None:
            mag = np.sum(np.abs(sig) ** norm) ** (1.0 / norm)
            sig = sig / max(mag, np.finfo(np.float64).tiny)
        filters.append(sig)
    max_len = max(lengths)
    if pad_fft:
        max_len = int(2.0 ** np.ceil(np.log2(max_len)))
    else:
        max_len = int(np.ceil(max_len))
    basis = np.asarray([_pad_center(f, max_len) for f in filters],
                       dtype=np.complex128)
    return basis, lengths


def vqt_filter_fft(sr: float, freqs: np.ndarray, filter_scale: float,
                   norm: float | None, sparsity: float,
                   hop_length: int | None = None, window: str = "hann",
                   gamma: float = 0, alpha=None,
                   force_n_fft: int | None = None):
    """FFT-domain basis (n_filters, n_fft//2+1), kept dense.

    ``force_n_fft`` zero-pads the wavelets into a larger common FFT
    length: the response Σ_f X[f] Ψ*[f] / n_fft is a Parseval inner
    product with the (compact-support) wavelet, so it is invariant to
    the padded length, and every octave can share one FFT length.
    """
    basis, lengths = wavelet(freqs, sr, window, filter_scale, True, norm,
                             gamma, alpha)
    n_fft = basis.shape[1]
    if (hop_length is not None
            and n_fft < 2.0 ** (1 + np.ceil(np.log2(hop_length)))):
        n_fft = int(2.0 ** (1 + np.ceil(np.log2(hop_length))))
    # Reference pipeline (third_party/librosa/constantq.py:96-103):
    # normalize by length/n_fft, FFT at the natural n_fft, then zero the
    # smallest spectral entries per row until 1 % of the L1 mass is
    # dropped, stored complex64.  Reproduce it exactly at the natural
    # length so golden values match bit-for-bit in f32.
    norm_basis = basis * (lengths[:, None] / float(n_fft))
    full = np.fft.fft(norm_basis, n=n_fft, axis=1)
    half = _sparsify_rows(full[:, : n_fft // 2 + 1], sparsity)
    half = half.astype(np.complex64).astype(np.complex128)
    if force_n_fft is None or force_n_fft == n_fft:
        return half, n_fft, lengths
    if force_n_fft < n_fft:
        raise ValueError("force_n_fft must be >= the natural length.")
    # Shared-FFT-plan padding: rebuild the (sparsified) wavelet in time,
    # center it in the longer window, re-FFT.  Frames are center-aligned,
    # so the inner product Σ_f X[f] Ψ*[f] / n_fft over the padded window
    # equals the natural-length one exactly (the wavelet is zero in the
    # padding), while every octave shares ONE FFT length.
    # The stored half-spectrum is a complex wavelet's, not Hermitian:
    # take the full natural-length spectrum with the same entries zeroed
    # in the kept half, and invert that.
    spec = full.copy()
    spec[:, : n_fft // 2 + 1] = np.where(half != 0,
                                         full[:, : n_fft // 2 + 1], 0.0)
    wav = np.fft.ifft(spec, axis=1)
    pad = force_n_fft - n_fft
    wav = np.pad(wav, ((0, 0), (pad // 2, pad - pad // 2)))
    fft_basis = np.fft.fft(wav, n=force_n_fft, axis=1)
    fft_basis = fft_basis[:, : force_n_fft // 2 + 1]
    # the consumer's inner product runs at force_n_fft, so the stored
    # normalization must be lengths / force_n_fft, not the natural-length
    # lengths / n_fft baked in above
    fft_basis *= n_fft / force_n_fft
    return fft_basis, force_n_fft, lengths


def _sparsify_rows(x: np.ndarray, quantile: float) -> np.ndarray:
    """Zero each row's smallest entries until ``quantile`` of its L1 mass
    is dropped (dense equivalent of librosa.util.sparsify_rows,
    reference: third_party/librosa/util.py:139-169)."""
    if quantile <= 0:
        return x
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


def num_two_factors(x: int) -> int:
    if x <= 0:
        return 0
    n = 0
    while x % 2 == 0:
        n += 1
        x //= 2
    return n


def early_downsample_count(nyquist: float, filter_cutoff: float,
                           hop_length: int, n_octaves: int) -> int:
    c1 = max(0, int(np.ceil(np.log2(nyquist / filter_cutoff)) - 1) - 1)
    c2 = max(0, num_two_factors(hop_length) - n_octaves + 1)
    return min(c1, c2)
