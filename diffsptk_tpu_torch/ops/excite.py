"""Excitation generation (counterpart of ``diffsptk_tpu/ops/excite.py``).

Pitch (period in samples, 0 = unvoiced) -> excitation.  The phase is the
running sum of the instantaneous frequency, reset at unvoiced regions by a
running maximum; every branch is a ``torch.where``, so the op is dense.
Random draws (the unvoiced region's noise, a random initial phase) come
from the port's copy of JAX's threefry stream under ``PRNGKey(seed)``, so
they are the JAX package's numbers; on the card a float32 Gaussian draw
launches the threefry kernel (``kernels/threefry.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, filter_values
from ..kernels import threefry
from ..signals import mseq
from ..utils import prng
from .linear_intpl import linear_interpolate

TAU = 2 * math.pi
UNVOICED_SYMBOL = 0


def _pulse_pos(phase):
    return torch.diff(torch.ceil(phase), dim=-1) >= 1


def generate_pulse(pitch, phase, bipolar):
    pos = _pulse_pos(phase)
    e = torch.where(pos, torch.sqrt(torch.clamp(pitch, min=0.0)),
                    torch.zeros_like(pitch))
    if bipolar:
        pos_double = _pulse_pos(0.5 * phase)
        e = torch.where(pos & ~pos_double, -e, e)
    return e


def generate_harmonic_pulse(pitch, phase, bipolar):
    n_harm = torch.floor(0.5 * pitch)
    theta = TAU * phase[..., :-1]
    half = 0.5 * theta
    if bipolar:
        numer = torch.cos(half) - torch.cos((n_harm + 0.5) * theta)
    else:
        numer = -torch.sin(half) + torch.sin((n_harm + 0.5) * theta)
    denom = 2 * torch.sin(half)
    eps = 1e-6
    singular = torch.abs(denom) < eps
    e = numer / torch.where(singular, torch.ones_like(denom), denom)
    e = torch.where(singular, torch.zeros_like(e) if bipolar else n_harm, e)
    return torch.sqrt(2 / torch.clamp(n_harm, min=1)) * e


def generate_sinusoidal(phase, bipolar):
    if bipolar:
        return torch.sin(TAU * phase)
    return 0.5 * (1 - torch.cos(TAU * phase))


def generate_sawtooth(phase, bipolar):
    e = torch.remainder(phase, 1)
    return 2 * e - 1 if bipolar else e


def generate_inverted_sawtooth(phase, bipolar):
    e = 1 - torch.remainder(phase, 1)
    return 2 * e - 1 if bipolar else e


def generate_triangle(phase, bipolar):
    if bipolar:
        return 2 * torch.abs(2 * torch.remainder(phase + 0.75, 1) - 1) - 1
    return torch.abs(2 * torch.remainder(phase + 0.5, 1) - 1)


def generate_square(phase, bipolar):
    e = (torch.remainder(phase, 1) <= 0.5).to(phase.dtype)
    return 2 * e - 1 if bipolar else e


class ExcitationGeneration(BaseOp):
    """Pitch (..., N) in samples -> excitation (..., N*P)."""

    def __init__(self, frame_period: int, *, voiced_region: str = "pulse",
                 unvoiced_region: str = "gauss", polarity: str = "auto",
                 init_phase: str | float = "zeros", seed: int = 0,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(frame_period: int) -> None:
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")

    @staticmethod
    def _design(frame_period: int, voiced_region: str = "pulse",
                unvoiced_region: str = "gauss", polarity: str = "auto",
                init_phase: str | float = "zeros", seed: int = 0) -> Design:
        ExcitationGeneration._check(frame_period)
        return Design(values={
            "frame_period": frame_period, "voiced_region": voiced_region,
            "unvoiced_region": unvoiced_region, "polarity": polarity,
            "init_phase": init_phase, "seed": seed})

    @staticmethod
    def _forward(p: torch.Tensor, *, frame_period: int, voiced_region: str,
                 unvoiced_region: str, polarity: str,
                 init_phase: str | float, seed: int) -> torch.Tensor:
        key = prng.PRNGKey(seed)              # on the host: no host read
        base_mask = torch.clamp(p, 0, 1)
        mask = torch.repeat_interleave(base_mask != UNVOICED_SYMBOL,
                                       frame_period, dim=-1)

        # Extend the last voiced pitch one frame into the unvoiced region
        # so interpolation has a right bracket.
        trans = torch.diff(F.pad(base_mask, (1, 0)), dim=-1) == -1
        p = torch.where(trans, torch.roll(p, 1, dims=-1), p)

        # Interpolate pitch to sample rate.
        p = linear_interpolate(p[..., None], frame_period)[..., 0]
        p = p * mask

        if not isinstance(init_phase, str):
            shift = init_phase / TAU
        elif init_phase == "zeros":
            shift = 0.0
        elif init_phase == "random":
            key, sub = prng.split(key)
            shift = prng.uniform(sub.to(p.device), p[..., :1].shape, p.dtype)
        else:
            raise ValueError(f"init_phase {init_phase} is not supported.")

        # The running sum of 1/p is taken in float64 on every device (the
        # JAX package takes it at the widest dtype it has: float64 under
        # x64, float32 on the TPU), which bounds the phase drift over long
        # signals.
        q = torch.where(p > 0, 1.0 / torch.where(p > 0, p,
                                                 torch.ones_like(p)),
                        torch.zeros_like(p)).double()
        s = torch.cumsum(q, dim=-1)
        bias = torch.cummax(s * ~mask, dim=-1).values
        phase = (s - bias).to(p.dtype)

        if polarity == "auto":
            bipolar = voiced_region != "pulse"
        elif polarity in ("unipolar", "bipolar"):
            bipolar = polarity == "bipolar"
        else:
            raise ValueError(f"polarity {polarity} is not supported.")

        if "pulse" in voiced_region:
            generators = {"pulse": generate_pulse,
                          "harmonic-pulse": generate_harmonic_pulse}
            if voiced_region not in generators:
                raise ValueError(
                    f"voiced_region {voiced_region} is not supported.")
            phase = F.pad(phase, (1, 0)) + shift
            e = generators[voiced_region](p, phase, bipolar)
        else:
            generators = {"sinusoidal": generate_sinusoidal,
                          "sawtooth": generate_sawtooth,
                          "inverted-sawtooth": generate_inverted_sawtooth,
                          "triangle": generate_triangle,
                          "square": generate_square}
            if voiced_region not in generators:
                raise ValueError(
                    f"voiced_region {voiced_region} is not supported.")
            phase = phase + shift
            e = torch.where(mask, generators[voiced_region](phase, bipolar),
                            torch.zeros_like(phase))

        if unvoiced_region == "zeros":
            pass
        elif unvoiced_region == "gauss":
            key, sub = prng.split(key)
            e = torch.where(mask, e, threefry.normal(sub, e.shape, e.dtype,
                                                     e.device))
        elif unvoiced_region == "m-sequence":
            noise = mseq(*e.shape[:-1], e.shape[-1] - 1, dtype=e.dtype,
                         device=e.device)
            e = torch.where(mask, e, noise)
        elif unvoiced_region == "uniform":
            key, sub = prng.split(key)
            e = torch.where(
                mask, e, math.sqrt(12) * prng.uniform(sub.to(e.device),
                                                      e.shape, e.dtype))
        else:
            raise ValueError(
                f"unvoiced_region {unvoiced_region} is not supported.")
        return e
