"""Line-spectral-pair conversions (counterpart of
``diffsptk_tpu/ops/lsp.py``).

lpc2lsp evaluates the palindromic sum and difference polynomials on the
unit circle as real cosine series and isolates their interlaced roots by
a sign-change grid and 40 bisection steps: batched, no host read.  A
float32 input is searched in float64, unlike the JAX package: in
float32, rounding in the series near a root now and then makes a
spurious sign change there, and the search then loses the last root (2
of 7,680 frames of synthetic speech in the JAX package, 14 in the port
on an H100; CPU and chip runs).  In float64 none did.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import BaseOp, Design, check_size, filter_values
from .parcor import lpc2par, par2lpc
from .rootpol import roots_to_polynomial

TAU = 2 * math.pi
LOG_ZERO = -1.0e10


def _palindromic_cos_series(c: torch.Tensor) -> torch.Tensor:
    """For palindromic coefficients c (length D+1, D even), the cosine
    series g with G(w) = g[0] + sum_k g[k] cos(k w)
    = e^{j D w/2} C(e^{-jw})."""
    half = (c.shape[-1] - 1) // 2
    return torch.cat((c[..., half:half + 1],
                      2 * torch.flip(c[..., :half], (-1,))), dim=-1)


def _cos_eval(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The cosine series g (..., half+1) at angles w (..., R) -> (..., R)."""
    k = torch.arange(g.shape[-1], dtype=w.dtype, device=w.device)
    return torch.sum(torch.cos(w[..., None] * k) * g[..., None, :], dim=-1)


def _find_unit_circle_roots(c: torch.Tensor, n_roots: int, n_grid: int,
                            n_bisect: int = 40) -> torch.Tensor:
    """The roots in (0, pi) of a palindromic polynomial, batched."""
    g = _palindromic_cos_series(c)
    w = torch.linspace(0.0, math.pi, n_grid + 1, dtype=c.dtype,
                       device=c.device)
    G = _cos_eval(g, w.expand(c.shape[:-1] + w.shape))
    sign_change = (G[..., :-1] * G[..., 1:]) <= 0
    csum = torch.cumsum(sign_change.to(torch.int32), dim=-1)
    idx = torch.stack([torch.argmax((csum >= r + 1).to(torch.uint8), dim=-1)
                       for r in range(n_roots)], dim=-1)
    lo, hi = w[idx], w[idx + 1]
    G_lo = _cos_eval(g, lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        G_mid = _cos_eval(g, mid)
        same = (G_lo * G_mid) > 0
        lo = torch.where(same, mid, lo)
        G_lo = torch.where(same, G_mid, G_lo)
        hi = torch.where(same, hi, mid)
    return 0.5 * (lo + hi)


def _deconv_small(x: torch.Tensor, kernel: tuple) -> torch.Tensor:
    """Exact polynomial division by a tiny kernel."""
    cols = list(x.unbind(-1))
    q = []
    for t in range(x.shape[-1] - len(kernel) + 1):
        qt = cols[t] / kernel[0]
        q.append(qt)
        for j, kj in enumerate(kernel[1:], 1):
            if kj != 0:
                cols[t + j] = cols[t + j] - qt * kj
    return torch.stack(q, dim=-1)


def _lsp_formatter(fmt, sample_rate, inverse: bool):
    """Radians to the named unit, or back with ``inverse``."""
    if fmt in (0, "radian"):
        scale = 1.0
    elif fmt in (1, "cycle"):
        scale = TAU
    elif fmt in (2, "khz"):
        scale = TAU / sample_rate * 1000
    elif fmt in (3, "hz"):
        scale = TAU / sample_rate
    else:
        raise ValueError(f"format {fmt} is not supported.")
    if scale == 1.0:
        return lambda x: x
    return (lambda x: x * scale) if inverse else (lambda x: x / scale)


class LinearPredictiveCoefficientsToLineSpectralPairs(BaseOp):
    """LPC (..., M+1) -> LSP frequencies [K, w1..wM]."""

    def __init__(self, lpc_order: int, *, log_gain: bool = False,
                 sample_rate: int | None = None,
                 out_format: str | int = "radian",
                 n_grid: int | None = None, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lpc_order: int, log_gain: bool, sample_rate: int | None,
               out_format) -> None:
        if lpc_order < 0:
            raise ValueError("lpc_order must be non-negative.")
        if out_format in (2, 3, "hz", "khz") and (
                sample_rate is None or sample_rate <= 0):
            raise ValueError("sample_rate must be positive.")

    @staticmethod
    def _design(lpc_order: int, log_gain: bool = False,
                sample_rate: int | None = None,
                out_format: str | int = "radian",
                n_grid: int | None = None) -> Design:
        LinearPredictiveCoefficientsToLineSpectralPairs._check(
            lpc_order, log_gain, sample_rate, out_format)
        if n_grid is None:
            n_grid = max(128, 64 * (lpc_order + 1))
        return Design(values={
            "log_gain": log_gain, "n_grid": n_grid,
            "formatter": _lsp_formatter(out_format, sample_rate, False)})

    @staticmethod
    def _forward(a: torch.Tensor, *, log_gain: bool, formatter,
                 n_grid: int) -> torch.Tensor:
        if a.dtype == torch.float32:
            return LinearPredictiveCoefficientsToLineSpectralPairs._forward(
                a.double(), log_gain=log_gain, formatter=formatter,
                n_grid=n_grid).float()
        M = a.shape[-1] - 1
        K, a1 = a[..., :1], a[..., 1:]
        if log_gain:
            K = torch.log(K)
        if M == 0:
            return K
        az = F.pad(F.pad(a1, (1, 0), value=1.0), (0, 1))
        p = az - torch.flip(az, (-1,))
        q = az + torch.flip(az, (-1,))
        if M % 2 == 0:
            p = _deconv_small(p, (1.0, -1.0))
            q = _deconv_small(q, (1.0, 1.0))
            wp = _find_unit_circle_roots(p, M // 2, n_grid)
            wq = _find_unit_circle_roots(q, M // 2, n_grid)
        else:
            p = _deconv_small(p, (1.0, 0.0, -1.0))
            wp = (_find_unit_circle_roots(p, (M - 1) // 2, n_grid)
                  if M > 1 else a1[..., :0])
            wq = _find_unit_circle_roots(q, (M + 1) // 2, n_grid)
        w = torch.sort(torch.cat((wp, wq), dim=-1), dim=-1).values
        return torch.cat((K, formatter(w)), dim=-1)

    def forward(self, a):
        check_size(a.shape[-1], self.in_dim, "dimension of LPC")
        return super().forward(a)


def _corr(x: torch.Tensor, k: tuple, padding: int = 0) -> torch.Tensor:
    """Cross-correlation with a small static kernel."""
    if padding:
        x = F.pad(x, (padding, padding))
    T = x.shape[-1] - len(k) + 1
    return sum(x[..., j:j + T] * kj for j, kj in enumerate(k) if kj != 0)


class LineSpectralPairsToLinearPredictiveCoefficients(BaseOp):
    """LSP -> LPC by P/Q polynomial reconstruction."""

    def __init__(self, lpc_order: int, *, log_gain: bool = False,
                 sample_rate: int | None = None,
                 in_format: str | int = "radian", dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(lpc_order: int, log_gain: bool = False,
                sample_rate: int | None = None,
                in_format: str | int = "radian") -> Design:
        LinearPredictiveCoefficientsToLineSpectralPairs._check(
            lpc_order, log_gain, sample_rate, in_format)
        return Design(values={
            "log_gain": log_gain,
            "formatter": _lsp_formatter(in_format, sample_rate, True)})

    @staticmethod
    def _forward(w: torch.Tensor, *, log_gain: bool,
                 formatter) -> torch.Tensor:
        M = w.shape[-1] - 1
        K, w1 = w[..., :1], w[..., 1:]
        if log_gain:
            K = torch.exp(K)
        if M == 0:
            return K
        z = torch.exp(1j * formatter(w1))
        p_roots, q_roots = z[..., 1::2], z[..., 0::2]
        q = roots_to_polynomial(torch.cat((q_roots, q_roots.conj()), dim=-1))
        if M == 1:
            a = 0.5 * q[..., 1:-1]
        else:
            p = roots_to_polynomial(torch.cat((p_roots, p_roots.conj()),
                                              dim=-1))
            if M % 2 == 0:
                p = _corr(p, (-1.0, 1.0))
                q = _corr(q, (1.0, 1.0))
            else:
                p = _corr(p, (-1.0, 0.0, 1.0), padding=1)
                q = _corr(q, (0.0, 1.0, 0.0))
            a = 0.5 * (p + q)
        return torch.cat((K, a.real), dim=-1)

    def forward(self, w):
        check_size(w.shape[-1], self.in_dim, "dimension of LSP")
        return super().forward(w)


def _floor_log(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.log(x), min=LOG_ZERO)


class LineSpectralPairsToSpectrum(BaseOp):
    """LSP -> log or power spectrum by the closed-form cosine product."""

    def __init__(self, lsp_order: int, fft_length: int, *,
                 alpha: float = 0, gamma: float = -1,
                 log_gain: bool = False, out_format: str | int = "power",
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = lsp_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lsp_order: int, fft_length: int, alpha: float,
               gamma: float) -> None:
        if lsp_order < 0:
            raise ValueError("lsp_order must be non-negative.")
        if fft_length <= 1:
            raise ValueError("fft_length must be greater than 1.")
        if 1 <= abs(alpha):
            raise ValueError("alpha must be in (-1, 1).")
        if not -1 <= gamma < 0:
            raise ValueError("gamma must be in [-1, 0).")

    @staticmethod
    def _design(lsp_order: int, fft_length: int, alpha: float = 0,
                gamma: float = -1, log_gain: bool = False,
                out_format: str | int = "power") -> Design:
        LineSpectralPairsToSpectrum._check(lsp_order, fft_length, alpha,
                                           gamma)
        if out_format in (0, "db"):
            formatter = lambda x: x * (20 / math.log(10))  # noqa: E731
        elif out_format in (1, "log-magnitude"):
            formatter = lambda x: x  # noqa: E731
        elif out_format in (2, "magnitude"):
            formatter = torch.exp
        elif out_format in (3, "power"):
            formatter = lambda x: torch.exp(2 * x)  # noqa: E731
        else:
            raise ValueError(f"out_format {out_format} is not supported.")

        c1 = 0.5 / gamma
        c2 = np.log(2) * (lsp_order if lsp_order % 2 == 0 else lsp_order - 1)
        omega = np.linspace(0, np.pi, fft_length // 2 + 1)
        warped = omega + 2 * np.arctan(
            alpha * np.sin(omega) / (1 - alpha * np.cos(omega)))

        def floor_log_np(x):
            with np.errstate(divide="ignore", invalid="ignore"):
                y = np.log(x)
            return np.nan_to_num(y, nan=LOG_ZERO, neginf=LOG_ZERO)

        if lsp_order % 2 == 0:
            p_bias = floor_log_np(np.sin(0.5 * warped))
            q_bias = floor_log_np(np.cos(0.5 * warped))
        else:
            p_bias = floor_log_np(np.sin(warped))
            q_bias = np.zeros_like(warped)
        return Design(
            values={"log_gain": log_gain, "formatter": formatter, "c1": c1,
                    "c2": float(c2)},
            arrays={"cos_omega": np.cos(warped)[:, None], "p_bias": p_bias,
                    "q_bias": q_bias})

    @staticmethod
    def _forward(w: torch.Tensor, *, log_gain: bool, formatter, c1: float,
                 c2: float, cos_omega: torch.Tensor, p_bias: torch.Tensor,
                 q_bias: torch.Tensor) -> torch.Tensor:
        K, w1 = w[..., :1], w[..., 1:]
        if not log_gain:
            K = _floor_log(K)
        pq = _floor_log(torch.abs(cos_omega - torch.cos(w1)[..., None, :]))
        p = torch.sum(pq[..., 1::2], dim=-1)
        q = torch.sum(pq[..., 0::2], dim=-1)
        a, b = 2 * (p + p_bias), 2 * (q + q_bias)
        m = torch.maximum(a, b)
        r = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
        return formatter(K + c1 * (c2 + r))

    def forward(self, w):
        check_size(w.shape[-1], self.in_dim, "dimension of LSP")
        return super().forward(w)


class LinearPredictiveCoefficientsStabilityCheck(BaseOp):
    """Clip the PARCOR magnitudes to 1 - margin."""

    def __init__(self, lpc_order: int, margin: float = 1e-16,
                 warn_type: str = "warn", dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = lpc_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lpc_order: int, margin: float) -> None:
        if lpc_order < 0:
            raise ValueError("lpc_order must be non-negative.")
        if not 0 < margin < 1:
            raise ValueError("margin must be in (0, 1).")

    @staticmethod
    def _design(lpc_order: int, margin: float = 1e-16,
                warn_type: str = "warn") -> Design:
        LinearPredictiveCoefficientsStabilityCheck._check(lpc_order, margin)
        return Design(values={"bound": 1 - margin, "warn_type": warn_type})

    @staticmethod
    def _forward(a: torch.Tensor, *, bound: float,
                 warn_type: str) -> torch.Tensor:
        k = lpc2par(a)
        k1 = torch.clamp(k[..., 1:], -bound, bound)
        return par2lpc(torch.cat((k[..., :1], k1), dim=-1))

    def forward(self, a):
        check_size(a.shape[-1], self.in_dim, "dimension of LPC")
        return super().forward(a)


class LineSpectralPairsStabilityCheck(BaseOp):
    """Repair LSPs that break the ordering or minimal-distance
    constraints."""

    def __init__(self, lsp_order: int, rate: float = 0.0, n_iter: int = 1,
                 warn_type: str = "warn", dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = lsp_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(lsp_order: int, rate: float, n_iter: int) -> None:
        if lsp_order < 0:
            raise ValueError("lsp_order must be non-negative.")
        if not 0 <= rate <= 1:
            raise ValueError("rate must be in [0, 1].")
        if n_iter < 0:
            raise ValueError("n_iter must be non-negative.")

    @staticmethod
    def _design(lsp_order: int, rate: float = 0.0, n_iter: int = 1,
                warn_type: str = "warn") -> Design:
        LineSpectralPairsStabilityCheck._check(lsp_order, rate, n_iter)
        return Design(values={
            "min_distance": rate * np.pi / (lsp_order + 1),
            "n_iter": n_iter, "warn_type": warn_type})

    @staticmethod
    def _forward(w: torch.Tensor, *, min_distance: float, n_iter: int,
                 warn_type: str) -> torch.Tensor:
        K = w[..., :1]
        cols = list(w[..., 1:].unbind(-1))
        for _ in range(n_iter):
            for m in range(len(cols) - 1):
                step = 0.5 * torch.clamp(min_distance - (cols[m + 1]
                                                         - cols[m]), min=0)
                cols[m] = cols[m] - step
                cols[m + 1] = cols[m + 1] + step
            cols = [torch.clamp(c, min_distance, np.pi - min_distance)
                    for c in cols]
        return torch.cat([K] + [c[..., None] for c in cols], dim=-1)

    def forward(self, w):
        check_size(w.shape[-1], self.in_dim, "dimension of LSP")
        return super().forward(w)
