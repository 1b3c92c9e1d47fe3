"""Static digital filters (counterpart of ``diffsptk_tpu/ops/dfs.py``).

An FIR filter is the port's padded unfold-dot (``_fir``); a true IIR
filter is ``lfilter``: the FIR numerator, then the all-pole recurrence
(kernels/recurrence.py).  ``ir_length`` truncates the filter to an FIR
approximation whose impulse response is made on the host in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import BaseOp, Design, child, filter_values
from ..kernels.recurrence import _fir, lfilter


def _impulse_response(b: np.ndarray, a: np.ndarray,
                      length: int) -> np.ndarray:
    """Truncated impulse response (host-side, float64).

    SPTK's convention: the recursion is seeded with a[0] and the feedback
    taps a[1:] are used unnormalized.
    """
    from scipy.signal import lfilter as sp_lfilter
    x = np.zeros(length)
    x[0] = a[0]
    a_mon = np.concatenate([[1.0], a[1:]])
    return sp_lfilter(b, a_mon, x)


class InfiniteImpulseResponseDigitalFilter(BaseOp):
    """y = (B(z)/A(z)) x with static coefficients.  With ``learnable``,
    the polynomials the caller gave become parameters."""

    def __init__(self, b=None, a=None, ir_length: int | None = None,
                 learnable: bool = False, dtype=None, device=None) -> None:
        super().__init__()
        design = self._design(**filter_values(locals(), ("learnable",)))
        learn = [name for name, given in (("b", b), ("a", a))
                 if learnable and given is not None
                 and name in design.arrays]
        self._setup(design, learnable=learn, dtype=dtype, device=device)

    @staticmethod
    def _check(ir_length: int | None) -> None:
        if ir_length is not None and ir_length <= 0:
            raise ValueError("ir_length must be positive.")

    @staticmethod
    def _design(b=None, a=None, ir_length: int | None = None) -> Design:
        InfiniteImpulseResponseDigitalFilter._check(ir_length)
        b_ary = np.asarray([1.0] if b is None else b, dtype=np.float64)
        a_ary = np.asarray([1.0] if a is None else a, dtype=np.float64)
        if a is None:
            return Design(values={"iir": False}, arrays={"b": b_ary})
        if ir_length is not None:
            h = _impulse_response(b_ary, a_ary, ir_length)
            return Design(values={"iir": False}, arrays={"b": h})
        return Design(values={"iir": True}, arrays={"b": b_ary, "a": a_ary})

    @staticmethod
    def _forward(x: torch.Tensor, *, iir: bool, b: torch.Tensor,
                 a: torch.Tensor | None = None) -> torch.Tensor:
        if not iir:
            return _fir(x, b)
        return lfilter(b, a, x)


class SecondOrderDigitalFilter(BaseOp):
    """Biquad given by pole and zero (frequency, bandwidth) pairs."""

    def __init__(self, sample_rate: int, pole_frequency=None,
                 pole_bandwidth=None, zero_frequency=None,
                 zero_bandwidth=None, ir_length: int | None = None,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(sample_rate: int, pole_frequency, pole_bandwidth,
               zero_frequency, zero_bandwidth) -> None:
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive.")
        for f in (pole_frequency, zero_frequency):
            if f is not None and not 0 < f <= sample_rate / 2:
                raise ValueError("frequency must be in (0, sample_rate/2].")
        for bw, f in ((pole_bandwidth, pole_frequency),
                      (zero_bandwidth, zero_frequency)):
            if f is not None and (bw is None or bw <= 0):
                raise ValueError("bandwidth must be positive.")

    @staticmethod
    def _design(sample_rate: int, pole_frequency=None, pole_bandwidth=None,
                zero_frequency=None, zero_bandwidth=None,
                ir_length: int | None = None) -> Design:
        SecondOrderDigitalFilter._check(
            sample_rate, pole_frequency, pole_bandwidth, zero_frequency,
            zero_bandwidth)

        def coefs(f, bw):
            r = math.exp(-math.pi * bw / sample_rate)
            theta = 2 * math.pi * f / sample_rate
            return [1.0, -2 * r * math.cos(theta), r * r]

        a = coefs(pole_frequency, pole_bandwidth) if pole_frequency else None
        b = coefs(zero_frequency, zero_bandwidth) if zero_frequency else None
        dfs = child(InfiniteImpulseResponseDigitalFilter, b=b, a=a,
                    ir_length=ir_length)
        return Design(layers={"dfs": dfs})

    @staticmethod
    def _forward(x: torch.Tensor, *, dfs) -> torch.Tensor:
        return dfs(x)
