"""Dynamic range compression (counterpart of ``diffsptk_tpu/ops/drc.py``).

A feed-forward compressor/expander gain computer (Giannoulis et al.
2012), then an attack/release one-pole smoother of the gain.  The
smoother's coefficient depends on whether the gain falls (``gt < prev``),
so it is not a linear recurrence and does not take the scan kernel: as
the JAX package runs it through ``lax.scan``, the port runs it as a loop
over time, a few small launches a sample on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import BaseOp, Design, filter_values


def ms2coef(ms: float, sample_rate: int) -> float:
    """One-pole coefficient of a time constant in ms."""
    return 1.0 - math.exp(-1000.0 / (ms * sample_rate))


def compexp_gain(x_rms: torch.Tensor, comp_thresh, comp_ratio, exp_thresh,
                 exp_ratio, at, rt) -> torch.Tensor:
    """Smoothed compressor/expander gain of |x| (linear in, linear out)."""
    x_db = 20.0 * torch.log10(x_rms)
    comp_slope = 1.0 - 1.0 / comp_ratio
    exp_slope = 1.0 - 1.0 / exp_ratio
    g_db = torch.clamp(
        torch.minimum(comp_slope * (comp_thresh - x_db),
                      exp_slope * (exp_thresh - x_db)), max=0.0)
    g = torch.pow(10.0, g_db / 20.0)

    prev = torch.ones_like(g[..., 0])
    ys = []
    for t in range(g.shape[-1]):
        gt = g[..., t]
        coef = torch.where(gt < prev, at, rt)
        prev = prev + coef * (gt - prev)
        ys.append(prev)
    return torch.stack(ys, dim=-1)


class DynamicRangeCompression(BaseOp):
    """Feed-forward compressor: gain computer and smoothed envelope."""

    def __init__(self, *, sample_rate: int, threshold: float = -20,
                 ratio: float = 2, attack_time: float = 1,
                 release_time: float = 500, makeup_gain: float = 0,
                 abs_max: float = 1, learnable: bool = False,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(
            self._design(**filter_values(locals(), ("learnable",))),
            learnable=learnable, dtype=dtype, device=device)

    @staticmethod
    def _check(ratio, attack_time, release_time, sample_rate, makeup_gain,
               abs_max) -> None:
        if ratio <= 1:
            raise ValueError("ratio must be greater than 1.")
        if attack_time <= 0:
            raise ValueError("attack_time must be positive.")
        if release_time <= 0:
            raise ValueError("release_time must be positive.")
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive.")
        if makeup_gain < 0:
            raise ValueError("makeup_gain must be non-negative.")
        if abs_max <= 0:
            raise ValueError("abs_max must be positive.")

    @staticmethod
    def _design(sample_rate: int, threshold: float = -20, ratio: float = 2,
                attack_time: float = 1, release_time: float = 500,
                makeup_gain: float = 0, abs_max: float = 1) -> Design:
        DynamicRangeCompression._check(ratio, attack_time, release_time,
                                       sample_rate, makeup_gain, abs_max)
        # The plain time constant 1 - exp(-1000 / (ms * sr)), as the JAX
        # package derives it from torchcomp's ms2coef (drc.py:95-99).
        params = np.array([
            threshold, ratio, ms2coef(attack_time, sample_rate),
            ms2coef(release_time, sample_rate),
            10.0 ** (makeup_gain / 20.0)])
        return Design(values={"abs_max": abs_max}, arrays={"params": params})

    @staticmethod
    def _forward(x: torch.Tensor, *, abs_max: float,
                 params: torch.Tensor) -> torch.Tensor:
        eps = 1e-10
        one_d = x.ndim == 1
        y = x[None] if one_d else x
        y_abs = torch.abs(y) / abs_max + eps
        g = compexp_gain(y_abs, params[0], params[1], -1000.0, eps,
                         params[2], params[3])
        y = y * g * params[4]
        return y[0] if one_d else y
