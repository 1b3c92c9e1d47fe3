"""WAV I/O and the frequency-warping factor chooser (counterpart of
``diffsptk_tpu/utils/wavio.py``).

I/O uses scipy (imported when a file is read or written); a waveform is a float tensor in [-1, 1] on the card unless
the caller passes ``device="cpu"``.  A file written by either package
reads back in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import resolve_device

# Traditional HTS warping factors per sample rate.
_HTS_ALPHA = {
    8000: 0.31, 10000: 0.35, 12000: 0.37, 16000: 0.42, 22050: 0.45,
    24000: 0.47, 32000: 0.50, 44100: 0.53, 48000: 0.55,
}


def get_alpha(sample_rate: int, mode: str = "hts", n_freq: int = 10,
              n_alpha: int = 100) -> float:
    """A first-order all-pass warping factor for the sample rate.

    ``"hts"`` looks up the traditional HTS table; ``"auto"`` minimises the
    L2 distance between the warped frequency axis and the mel scale.
    """
    if mode == "hts":
        sr = int(sample_rate)
        if sr not in _HTS_ALPHA:
            raise ValueError(
                f"Unsupported sample rate: {sample_rate}. Please use "
                "mode='auto'.")
        return _HTS_ALPHA[sr]
    if mode != "auto":
        raise ValueError("Only hts and auto are supported.")

    # the mel-scale frequencies, normalised to [0, pi]
    freq = np.arange(n_freq) * (0.5 * sample_rate / (n_freq - 1))
    mel = np.log1p(freq / 1000.0)
    mel = mel * (np.pi / mel[-1])

    # the phase response of the first-order all-pass for each candidate
    alpha = np.linspace(0.0, 1.0, n_alpha, endpoint=False)[:, None]
    omega = np.arange(n_freq) * (np.pi / (n_freq - 1))
    numer = (1.0 - alpha * alpha) * np.sin(omega)
    denom = (1.0 + alpha * alpha) * np.cos(omega) - 2.0 * alpha
    warped = np.arctan(numer / denom)
    warped = np.where(warped < 0, warped + np.pi, warped)

    dist = np.square(mel[None, :] - warped).sum(axis=1)
    return float(alpha[np.argmin(dist), 0])


def read(filename: str, dtype=None, channel_first: bool = True,
         device=None):
    """Read a wav file -> (waveform in [-1, 1], sample_rate).

    The shape is (T,) for mono, (C, T) if ``channel_first`` else (T, C).
    """
    from scipy.io import wavfile

    sr, x = wavfile.read(filename)
    if x.dtype == np.int16:
        x = x.astype(np.float64) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float64) / 2147483648.0
    elif x.dtype == np.uint8:
        x = (x.astype(np.float64) - 128.0) / 128.0
    else:
        x = x.astype(np.float64)
    if x.ndim == 2 and channel_first:
        x = x.T
    y = torch.as_tensor(np.ascontiguousarray(x),
                        dtype=dtype or torch.get_default_dtype(),
                        device=resolve_device(device))
    return y, sr


def write(filename: str, x, sample_rate: int, channel_first: bool = True,
          subtype: str | None = None) -> None:
    """Write a waveform in [-1, 1] to a 16-bit (or float) wav file."""
    from scipy.io import wavfile

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.ndim == 2 and channel_first:
        x = x.T
    if subtype in (None, "PCM_16"):
        data = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    elif subtype == "FLOAT":
        data = x.astype(np.float32)
    else:
        raise ValueError(f"subtype {subtype} is not supported.")
    wavfile.write(filename, sample_rate, data)
