"""Pitch extraction by YIN (counterpart of ``diffsptk_tpu/ops/pitch.py``).

A batched YIN tracker: FFT-based difference function, cumulative-mean
normalization, threshold dip picking with parabolic refinement.  The
neural trackers (``algorithm="crepe"`` / ``"fcnf0"``) are not ported yet
and raise ``NotImplementedError``.

Output formats: pitch (period in samples), f0, log-f0 (unvoiced ->
-1e10), prob.  The output carries no gradient, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import full_precision, resolve_device

UNVOICED_SYMBOL = 0.0


def _yin_frames(x: torch.Tensor, frame_period: int, window_length: int,
                tau_max: int) -> torch.Tensor:
    """Frames of length window_length + tau_max every frame_period
    (centered, zero-padded): T // P + 1 of them."""
    L = window_length + tau_max
    P = frame_period
    T = x.shape[-1]
    n_frames = T // P + 1
    K = -(-L // P)
    total = (n_frames + K) * P
    xp = F.pad(x, (L // 2, max(total - L // 2 - T, 0)))[..., :total]
    return xp.unfold(-1, L, P)[..., :n_frames, :]


def yin_difference(frames: torch.Tensor, window_length: int,
                   tau_max: int) -> torch.Tensor:
    """d[tau] = sum_{j<W} (x[j] - x[j+tau])^2 for tau in [0, tau_max)."""
    L = frames.shape[-1]
    n_fft = 1
    while n_fft < 2 * L:
        n_fft *= 2
    head = frames[..., :window_length]
    F_full = torch.fft.rfft(frames, n=n_fft)
    F_head = torch.fft.rfft(head, n=n_fft)
    acf = torch.fft.irfft(torch.conj(F_head) * F_full, n=n_fft)[..., :tau_max]
    sq = torch.cumsum(torch.square(frames), dim=-1)
    e0 = sq[..., window_length - 1]
    pad = F.pad(sq, (1, 0))
    e_tau = (pad[..., window_length:window_length + tau_max]
             - pad[..., :tau_max])
    return e0[..., None] + e_tau - 2 * acf


def yin_cmnd(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference; d'[0] = 1."""
    tau = torch.arange(d.shape[-1], dtype=d.dtype, device=d.device)
    csum = torch.cumsum(d, dim=-1)
    cm = d * tau / torch.where(csum == 0, torch.ones_like(csum), csum)
    return torch.cat([torch.ones_like(cm[..., :1]), cm[..., 1:]], dim=-1)


class PitchExtractionByYIN:
    def __init__(self, frame_period: int, sample_rate: int, *,
                 f_min: float = 60.0, f_max: float = 500.0,
                 voicing_threshold: float = 0.3,
                 window_length: int | None = None) -> None:
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.f_min = f_min
        self.f_max = f_max
        self.voicing_threshold = voicing_threshold
        self.tau_min = max(int(sample_rate / f_max), 2)
        self.tau_max = int(np.ceil(sample_rate / f_min)) + 1
        self.window_length = window_length or 2 * self.tau_max

    def calc_prob(self, x: torch.Tensor) -> torch.Tensor:
        frames = _yin_frames(x, self.frame_period, self.window_length,
                             self.tau_max)
        d = yin_difference(frames, self.window_length, self.tau_max)
        return yin_cmnd(d)

    def calc_embed(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "out_format 'embed' requires algorithm='crepe'.")

    def calc_pitch(self, x: torch.Tensor) -> torch.Tensor:
        """f0 in Hz with 0 at unvoiced frames."""
        cm = self.calc_prob(x)                           # (..., N, tau_max)
        tau_axis = torch.arange(self.tau_max, device=cm.device)
        in_range = (self.tau_min <= tau_axis) & (tau_axis
                                                 < self.tau_max - 1)
        inf = torch.full_like(cm, float("inf"))
        cm_masked = torch.where(in_range, cm, inf)

        # first local minimum below the threshold (YIN step 4)
        prev = torch.cat([cm[..., :1] + 1, cm[..., :-1]], dim=-1)
        nxt = torch.cat([cm[..., 1:], cm[..., -1:] + 1], dim=-1)
        is_local_min = (cm < prev) & (cm <= nxt)
        below = (cm_masked < self.voicing_threshold) & is_local_min
        any_below = torch.any(below, dim=-1)
        # argmax/argmin return the first extremum, as in JAX
        first_dip = torch.argmax(below.to(torch.uint8), dim=-1)
        global_min = torch.argmin(cm_masked, dim=-1)
        t = torch.where(any_below, first_dip, global_min)

        # parabolic interpolation around the dip
        tm = torch.clamp(t - 1, 0, self.tau_max - 1)
        tp = torch.clamp(t + 1, 0, self.tau_max - 1)
        ym = torch.gather(cm, -1, tm[..., None])[..., 0]
        y0 = torch.gather(cm, -1, t[..., None])[..., 0]
        yp = torch.gather(cm, -1, tp[..., None])[..., 0]
        denom = ym - 2 * y0 + yp
        safe = torch.where(denom == 0, torch.ones_like(denom), denom)
        offset = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / safe,
                             torch.zeros_like(denom))
        offset = torch.clamp(offset, -1.0, 1.0)
        tau_ref = t.to(cm.dtype) + offset

        cmin = torch.amin(cm_masked, dim=-1)
        voiced = cmin < self.voicing_threshold
        f0 = self.sample_rate / torch.clamp(tau_ref, min=1.0)
        return torch.where(voiced, f0, torch.full_like(f0, UNVOICED_SYMBOL))


class Pitch(nn.Module):
    """Waveform (B?, T) -> pitch/f0/log-f0 (B?, N) or prob (B?, N, C).

    ``device`` and ``dtype`` are accepted for the port's op signature;
    the tracker holds no tensors, so its output follows the input's.
    """

    def __init__(self, frame_period: int, sample_rate: int,
                 algorithm: str = "yin", out_format: str | int = "pitch",
                 device=None, dtype=None, **kwargs) -> None:
        super().__init__()
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if sample_rate < 8000:
            raise ValueError("sample_rate must be at least 8000 Hz.")
        resolve_device(device)
        if algorithm == "yin":
            self.extractor = PitchExtractionByYIN(frame_period, sample_rate,
                                                  **kwargs)
        elif algorithm in ("crepe", "fcnf0"):
            raise NotImplementedError(
                f"algorithm {algorithm} is not ported yet (pitch_nn)")
        else:
            raise ValueError(f"algorithm {algorithm} is not supported.")

        def calc_pitch(x, convert, unvoiced_symbol=UNVOICED_SYMBOL):
            f0 = self.extractor.calc_pitch(x)
            mask = f0 != UNVOICED_SYMBOL
            safe = torch.where(mask, f0, torch.ones_like(f0))
            return torch.where(mask, convert(safe),
                               torch.full_like(f0, unvoiced_symbol))

        if out_format in (0, "pitch"):
            self.convert = lambda x: calc_pitch(x, lambda y: sample_rate / y)
        elif out_format in (1, "f0"):
            self.convert = lambda x: calc_pitch(x, lambda y: y)
        elif out_format in (2, "log-f0"):
            self.convert = lambda x: calc_pitch(x, torch.log, -1.0e10)
        elif out_format == "prob":
            self.convert = self.extractor.calc_prob
        elif out_format == "embed":
            self.convert = self.extractor.calc_embed
        else:
            raise ValueError(f"out_format {out_format} is not supported.")

    @full_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convert(x).detach()
