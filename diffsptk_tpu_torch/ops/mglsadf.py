"""Pseudo MGLSA digital filter (counterpart of
``diffsptk_tpu/ops/mglsadf.py``), in four modes:

* multi-stage -- the Taylor cascade e^F ~= sum a_i F^i / i!: every stage
  filters with the same per-frame coefficients.  Long filters (M+1 > 32)
  take the folded-plan cascade in plain torch (``cascade="folded"``), the
  CUDA cascade kernel on the card (``cascade="fused"``), or one
  frame-blocked FFT filter per stage sharing one coefficient spectrum
  (``cascade="stages"``); short ones the direct all-zero filter;
* single-stage -- one long time-varying FIR whose impulse response comes
  from mgc2mgc or an FFT;
* freq-domain -- istft(mgc2sp(mc) * stft(x));
* pade-approx -- the [L/L] Pade approximant of exp: two FIR numerator
  stages, then 2L complex all-pole sections with host-computed roots; the
  first-order ones run the scan kernel on the card.

Phase in {minimum, maximum, zero, mixed} (pade-approx: minimum only).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import check_size, child, full_precision, place
from ..kernels.mlsa import PRECISIONS, taylor_cascade
from ..kernels.mlsa_cascade import lane_aligned_nfft, taylor_cascade_folded
from ..kernels.recurrence import sample_wise_lpc
from ..utils.linalg import remove_gain
from .gnorm import GeneralizedCepstrumGainNormalization, get_gamma
from .linear_intpl import linear_interpolate
from .mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)
from .mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from .mgc2sp import MelGeneralizedCepstrumToSpectrum
from .stft import (
    InverseShortTimeFourierTransform,
    ShortTimeFourierTransform,
)
from .zerodf import AllZeroDigitalFilter, _next_pow2, zerodf_fft


def mirror(x: torch.Tensor, half: bool = False) -> torch.Tensor:
    x0, x1 = x[..., :1], x[..., 1:]
    if half:
        x1 = x1 * 0.5
    return torch.cat((torch.flip(x1, (-1,)), x0, x1), dim=-1)


def _exp_taylor_weights(order: int) -> np.ndarray:
    """weights[i] = cp[i]/cp[i-1] for cp = Taylor coefficients of exp
    (i.e. 1/i), with weights[0] = 1."""
    cp = np.array([1.0 / math.factorial(k) for k in range(order + 1)])
    w = cp[1:] / cp[:-1]
    return np.insert(w, 0, 1.0)


def _exp_pade_weights(order: int) -> np.ndarray:
    """Ratios of the numerator coefficients of the [L/L] Pade approximant
    of exp, p_k = (2L-k)! L! / ((2L)! k! (L-k)!), with weights[0] = 1."""
    f = math.factorial
    cp = np.array([f(2 * order - k) * f(order)
                   / (f(2 * order) * f(k) * f(order - k))
                   for k in range(order + 1)])
    w = cp[1:] / cp[:-1]
    return np.insert(w, 0, 1.0)


class MultiStageFIRFilter(nn.Module):
    """Taylor-series cascade of time-varying FIR stages."""

    def __init__(self, filter_order, frame_period, *, alpha=0.0, gamma=0.0,
                 ignore_gain=False, phase="minimum", taylor_order=20,
                 cep_order=199, n_fft=512, cascade="folded",
                 cascade_precision=None, learnable=False, dtype=None,
                 device=None):
        super().__init__()
        if taylor_order < 0:
            raise ValueError("taylor_order must be non-negative.")
        if cascade not in ("stages", "folded", "fused"):
            raise ValueError(
                "cascade must be 'stages', 'folded', or 'fused'.")
        if cascade_precision is not None and \
                cascade_precision not in PRECISIONS:
            raise ValueError(f"cascade_precision must be in {PRECISIONS}")
        self.ignore_gain = ignore_gain
        self.phase = phase
        self.frame_period = frame_period
        # "folded": plain torch matmul plans; "fused": the CUDA cascade
        # kernels on the card; "stages": one FFT filter per stage.  The
        # same math.  Where the cascade runs float32, cascade_precision
        # sets the plan products' arithmetic of "folded" and "fused"
        # (kernels/mlsa.py): None and "HIGHEST" full fp32 (the JAX
        # package's folded None means HIGH), "HIGH" bf16x3, "DEFAULT" one
        # bf16 pass.
        self.cascade = cascade
        self.cascade_precision = cascade_precision

        if alpha == 0 and gamma == 0:
            cep_order = filter_order

        if phase == "minimum":
            cep_orders = (cep_order, 0)
        elif phase == "maximum":
            cep_orders = (0, cep_order)
        elif phase == "zero":
            cep_orders = (cep_order, cep_order)
        elif phase == "mixed":
            cep_orders = ((cep_order, cep_order)
                          if isinstance(cep_order, int) else cep_order)
        else:
            raise ValueError(f"phase {phase} is not supported.")
        self.cep_orders = cep_orders

        def mgc2c(order, out_order):
            return child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                         in_order=order, out_order=out_order,
                         in_alpha=alpha, in_gamma=gamma, n_fft=n_fft)

        if phase == "mixed":
            self.mgc2c = nn.ModuleList(
                [mgc2c(filter_order[i], cep_orders[i]) for i in range(2)])
        else:
            self.mgc2c = mgc2c(filter_order, cep_order)

        self.zerodf = child(AllZeroDigitalFilter,
                            filter_order=sum(cep_orders),
                            frame_period=frame_period, ignore_gain=False,
                            zeroth_index=cep_orders[1])

        self.register_buffer(
            "weights", torch.as_tensor(_exp_taylor_weights(taylor_order)))
        a = torch.ones(taylor_order + 1, dtype=torch.float64)
        if learnable:
            self.a = nn.Parameter(a)
        else:
            self.register_buffer("a", a)
        place(self, device, dtype)

    @full_precision
    def forward(self, x, mc, a=None):
        a = self.a if a is None else a
        if self.phase == "mixed":
            mc_min, mc_max = mc
            c_min = self.mgc2c[0](mc_min)
            c_max = self.mgc2c[1](mc_max)
            c0 = c_min[..., :1] + c_max[..., :1]
            c = torch.cat([torch.flip(c_max[..., 1:], (-1,)),
                           torch.zeros_like(c0), c_min[..., 1:]], dim=-1)
        else:
            c = self.mgc2c(mc)
            c0, c = remove_gain(c, value=0.0, return_gain=True)
            if self.phase == "maximum":
                c = torch.flip(c, (-1,))
            elif self.phase == "zero":
                c = mirror(c, half=True)

        M = c.shape[-1] - 1
        if M + 1 > 32:
            # Every Taylor stage filters with the same coefficients, so
            # the per-frame coefficient spectrum is shared across stages.
            P = self.frame_period
            advance = self.zerodf.padding[1]
            nfft = lane_aligned_nfft(2 * P + M + 1)
            if self.cascade == "stages":
                nfft_fft = _next_pow2(2 * P + M + 1)
                c_spec = torch.fft.rfft(c, n=nfft_fft)
                y = x * a[0]
                for i in range(1, a.shape[0]):
                    x = zerodf_fft(x, c, P, advance=advance, b_spec=c_spec,
                                   nfft=nfft_fft) * self.weights[i]
                    y = y + x * a[i]
            elif self.cascade == "fused" and x.dtype == torch.float32:
                # The cascade kernel takes float32; other dtypes take the
                # folded form, as in the JAX package.
                kw = ({"precision": self.cascade_precision}
                      if self.cascade_precision else {})
                y = taylor_cascade(x, c, self.weights, a, P, advance, nfft,
                                   **kw)
            else:
                y = taylor_cascade_folded(x, c, self.weights, a, P, advance,
                                          nfft, self.cascade_precision)
        else:
            y = x * a[0]
            for i in range(1, a.shape[0]):
                x = self.zerodf(x, c) * self.weights[i]
                y = y + x * a[i]

        if not self.ignore_gain:
            K = torch.exp(linear_interpolate(c0, self.frame_period))
            y = y * K[..., 0]
        return y


class SingleStageFIRFilter(nn.Module):
    """One long time-varying FIR whose impulse response comes from
    mgc2mgc (minimum and maximum phase) or an FFT (zero and mixed)."""

    def __init__(self, filter_order, frame_period, *, alpha=0.0, gamma=0.0,
                 ignore_gain=False, phase="minimum", ir_length=2000,
                 n_fft=4096, dtype=None, device=None):
        super().__init__()
        self.ignore_gain = ignore_gain
        self.phase = phase
        self.n_fft = n_fft
        self.ir_length = ir_length

        if phase == "minimum":
            ir_orders = (ir_length - 1, 0)
        elif phase == "maximum":
            ir_orders = (0, ir_length - 1)
        elif phase == "zero":
            ir_orders = (ir_length - 1, ir_length - 1)
        elif phase == "mixed":
            ir_orders = ((ir_length - 1, ir_length - 1)
                         if isinstance(ir_length, int)
                         else (ir_length[0] - 1, ir_length[1] - 1))
        else:
            raise ValueError(f"phase {phase} is not supported.")
        self.ir_orders = ir_orders

        def mgc2c(order, out_order, **kw):
            return child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                         in_order=order, out_order=out_order,
                         in_alpha=alpha, in_gamma=gamma, n_fft=n_fft, **kw)

        if phase in ("minimum", "maximum"):
            self.mgc2ir = mgc2c(filter_order, ir_length - 1, out_gamma=1,
                                out_mul=True)
        elif phase == "zero":
            self.mgc2c = mgc2c(filter_order, ir_length - 1)
        else:
            self.mgc2c = nn.ModuleList(
                [mgc2c(filter_order[i], ir_orders[i]) for i in range(2)])

        self.zerodf = child(AllZeroDigitalFilter,
                            filter_order=sum(ir_orders),
                            frame_period=frame_period, ignore_gain=False,
                            zeroth_index=ir_orders[1])
        place(self, device, dtype)

    @full_precision
    def forward(self, x, mc):
        n_fft = self.n_fft
        if self.phase in ("minimum", "maximum"):
            h = self.mgc2ir(mc)
            if self.ignore_gain:
                h = h / h[..., :1]
            if self.phase == "maximum":
                h = torch.flip(h, (-1,))
        elif self.phase == "zero":
            c = self.mgc2c(mc)
            c = torch.cat((c[..., :1], c[..., 1:] * 0.5), dim=-1)
            if self.ignore_gain:
                c = remove_gain(c, value=0.0)
            H = torch.fft.hfft(c, n=n_fft)
            h = mirror(torch.fft.ifft(torch.exp(H)).real[
                ..., :self.ir_length])
        else:
            mc_min, mc_max = mc
            c_min = self.mgc2c[0](mc_min)
            c_max = self.mgc2c[1](mc_max)
            if self.ignore_gain:
                c0 = torch.zeros_like(c_min[..., :1])
            else:
                c0 = c_min[..., :1] + c_max[..., :1]
            c = torch.cat([torch.flip(c_max[..., 1:], (-1,)), c0,
                           c_min[..., 1:]], dim=-1)
            c = F.pad(c, (0, n_fft - c.shape[-1]))
            shift = self.ir_orders[1]
            C = torch.fft.fft(torch.roll(c, -shift, dims=-1), n=n_fft)
            h = torch.fft.ifft(torch.exp(C.real)
                               * torch.exp(1j * C.imag)).real[..., :n_fft]
            h = torch.roll(h, shift, dims=-1)[..., :sum(self.ir_orders) + 1]
        return self.zerodf(x, h)


class FrequencyDomainFIRFilter(nn.Module):
    """Filtering in the STFT domain: istft(H * stft(x)), H the complex
    spectrum of the mel-cepstrum."""

    def __init__(self, filter_order, frame_period, *, alpha=0.0, gamma=0.0,
                 ignore_gain=False, phase="minimum", frame_length=400,
                 fft_length=512, n_fft=512, dtype=None, device=None,
                 **stft_kwargs):
        super().__init__()
        if frame_length <= 2 * frame_period:
            raise ValueError(
                "frame_period must be less than half of frame_length.")
        if phase not in ("minimum", "maximum", "zero", "mixed"):
            raise ValueError(f"phase {phase} is not supported.")
        self.ignore_gain = ignore_gain
        self.phase = phase

        if isinstance(filter_order, int):
            filter_order = (filter_order, filter_order)
        orders = filter_order[:2 if phase == "mixed" else 1]
        if ignore_gain:
            self.gnorm = nn.ModuleList(
                child(GeneralizedCepstrumGainNormalization, cep_order=m,
                      gamma=gamma) for m in orders)
            self.mc2b = nn.ModuleList(
                child(MelCepstrumToMLSADigitalFilterCoefficients,
                      cep_order=m, alpha=alpha) for m in orders)
            self.b2mc = nn.ModuleList(
                child(MLSADigitalFilterCoefficientsToMelCepstrum,
                      cep_order=m, alpha=alpha) for m in orders)
        self.mgc2sp = nn.ModuleList(
            child(MelGeneralizedCepstrumToSpectrum, cep_order=m,
                  fft_length=fft_length, alpha=alpha, gamma=gamma,
                  out_format="complex", n_fft=n_fft) for m in orders)
        self.stft = child(ShortTimeFourierTransform,
                          frame_length=frame_length,
                          frame_period=frame_period, fft_length=fft_length,
                          out_format="complex", **stft_kwargs)
        self.istft = child(InverseShortTimeFourierTransform,
                           frame_length=frame_length,
                           frame_period=frame_period, fft_length=fft_length,
                           **stft_kwargs)
        place(self, device, dtype)

    @full_precision
    def forward(self, x, mc):
        mcs = [mc] if isinstance(mc, torch.Tensor) else list(mc)
        Hs = []
        for i, c in enumerate(mcs):
            if self.ignore_gain:
                b = self.gnorm[i](self.mc2b[i](c))
                b = torch.cat([torch.zeros_like(b[..., :1]), b[..., 1:]],
                              dim=-1)
                c = self.b2mc[i](b)
            Hs.append(self.mgc2sp[i](c))

        if self.phase == "minimum":
            H = Hs[0]
        elif self.phase == "maximum":
            H = torch.conj(Hs[0])
        elif self.phase == "zero":
            H = torch.abs(Hs[0])
        else:
            H = Hs[0] * torch.conj(Hs[1])
        return self.istft(H * self.stft(x), out_length=x.shape[-1])


class MultiStageIIRFilter(nn.Module):
    """Pade cascade: two FIR numerator stages, then 2 * pade_order complex
    all-pole sections with roots computed on the host.  The first
    pade_order sections are first order (the scan kernel on the card);
    the others are of order M, the per-sample recurrence.  With
    ``chunk_length``, the sections run on overlapping chunks that each
    warm up over ``warmup_length`` samples."""

    def __init__(self, filter_order, frame_period, *, alpha=0.0, gamma=0.0,
                 ignore_gain=False, phase="minimum", pade_order=5,
                 cep_order=199, n_fft=512, chunk_length=None,
                 warmup_length=None, learnable=False, dtype=None,
                 device=None):
        super().__init__()
        if phase != "minimum" or not isinstance(filter_order, int):
            raise ValueError("Only minimum-phase filter is supported.")
        self.ignore_gain = ignore_gain
        self.frame_period = frame_period
        self.mgc2c = child(MelGeneralizedCepstrumToMelGeneralizedCepstrum,
                           in_order=filter_order, out_order=cep_order,
                           in_alpha=alpha, in_gamma=gamma, n_fft=n_fft)

        self.chunking = chunk_length is not None
        if self.chunking:
            if chunk_length <= 0:
                raise ValueError("chunk_length must be positive.")
            self.warmup_length = (warmup_length if warmup_length is not None
                                  else cep_order)
            self.chunk_length = chunk_length

        if pade_order == 3:
            a1 = np.linspace(1.0, 0.4, pade_order + 1)
        elif pade_order == 4:
            a1 = np.linspace(1.0, 0.6, pade_order + 1)
        elif 5 <= pade_order <= 14:
            a1 = np.ones(pade_order + 1)
        else:
            raise ValueError("pade_order must be in [3, 14].")
        self.pade_order = pade_order
        weights = _exp_pade_weights(pade_order)
        self.register_buffer("weights", torch.as_tensor(weights))
        # Only a1 is learnable.  The second numerator stage and the
        # denominator's roots keep a1's initial values, as in the JAX
        # package.
        if learnable:
            self.a1 = nn.Parameter(torch.tensor(a1))
        else:
            self.register_buffer("a1", torch.tensor(a1))
        self.register_buffer("a2", torch.tensor(a1))
        roots = np.roots((np.cumprod(weights) * a1)[::-1])
        # complex64 in a float32 module, so the sections stay complex64
        self.register_buffer("roots", torch.as_tensor(roots))
        place(self, device, dtype)

    @full_precision
    def forward(self, x, mc):
        one_d = x.ndim == 1
        if one_d:
            x, mc = x[None], mc[None]

        c = self.mgc2c(mc)
        c0, c1 = c[..., :1], c[..., 1:]
        P = self.frame_period
        c_b = linear_interpolate(torch.flip(c1, (-1,)), P)
        c_a = linear_interpolate(c1, P)
        T = x.shape[-1]
        B, _, M = c_a.shape
        a1, a2, weights = self.a1, self.a2, self.weights
        c_b2, c_b1 = c_b[..., :-1], c_b[..., -1]

        # Numerator, first stage: cascaded one-sample delays.
        y = x * a1[0]
        for i in range(1, a1.shape[0]):
            x = F.pad(x[..., :-1], (1, 0)) * c_b1 * weights[i]
            y = y + x * a1[i]

        # Numerator, second stage: order-(M-1) taps delayed by two or more.
        x = y
        y = x * a2[0]
        for i in range(1, a2.shape[0]):
            frames = F.pad(x, (M, 0)).unfold(-1, M + 1, 1)    # (B, T, M+1)
            x = torch.sum(frames[..., :-2] * c_b2, dim=-1) * weights[i]
            y = y + x * a2[i]

        if self.chunking:
            W, C = self.warmup_length, self.chunk_length
            hop = C - W
            y = F.pad(y, (W, 0))
            n_frames = (y.shape[-1] - C) // hop + 1
            y = y.unfold(-1, C, hop)[..., :n_frames, :].reshape(-1, C)
            ca = F.pad(c_a.reshape(B, -1), (M * W, 0))
            c_a = ca.unfold(-1, M * C, M * hop)[..., :n_frames, :]\
                .reshape(y.shape[0], C, M)

        c_a1 = c_a[..., :1]
        c_a2 = F.pad(c_a[..., 1:], (1, 0))
        y = y.to(torch.promote_types(y.dtype, self.roots.dtype))

        # Denominator: 2 * pade_order sequential complex sections.
        p = 1.0 / self.roots
        for i in range(self.pade_order):
            y = sample_wise_lpc(y, p[i] * c_a1)
        for i in range(self.pade_order):
            y = sample_wise_lpc(y, p[i] * c_a2)
        y = y.real

        if self.chunking:
            y = y[..., self.warmup_length:].reshape(B, -1)[..., :T]
        if not self.ignore_gain:
            y = y * torch.exp(linear_interpolate(c0, P))[..., 0]
        return y[0] if one_d else y


class PseudoMGLSADigitalFilter(nn.Module):
    """MLSA/MGLSA filter: (excitation (..., T), mel-cepstrum
    (..., T/P, M+1)) -> (..., T)."""

    def __init__(self, filter_order, frame_period: int, *, alpha: float = 0,
                 gamma: float = 0, c: int | None = None,
                 ignore_gain: bool = False, phase: str = "minimum",
                 mode: str = "multi-stage", dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        self.frame_period = frame_period

        if phase == "mixed":
            if isinstance(filter_order, int):
                filter_order = (filter_order, filter_order)
            self.split_sections = (filter_order[0], filter_order[1] + 1)
        else:
            if not isinstance(filter_order, int):
                raise ValueError(
                    "filter_order must be int unless phase is 'mixed'.")
            self.split_sections = (filter_order + 1,)
        gamma = get_gamma(gamma, c)

        def flip(v):
            return v if isinstance(v, int) else (v[1], v[0])

        kw = kwargs.copy()
        for key in ("cep_order", "ir_length"):
            if key in kw:
                kw[key] = flip(kw[key])
        fo = flip(filter_order)

        common = dict(alpha=alpha, gamma=gamma, ignore_gain=ignore_gain,
                      phase=phase)
        if mode == "multi-stage":
            self.mglsadf = MultiStageFIRFilter(fo, frame_period, **common,
                                               **kw, device=device,
                                               dtype=dtype)
        elif mode == "single-stage":
            self.mglsadf = SingleStageFIRFilter(fo, frame_period, **common,
                                                **kw, device=device,
                                                dtype=dtype)
        elif mode == "freq-domain":
            self.mglsadf = FrequencyDomainFIRFilter(fo, frame_period,
                                                    **common, **kw,
                                                    device=device,
                                                    dtype=dtype)
        elif mode == "pade-approx":
            self.mglsadf = MultiStageIIRFilter(fo, frame_period, **common,
                                               **kw, device=device,
                                               dtype=dtype)
        else:
            raise ValueError(f"mode {mode} is not supported.")

    def forward(self, x: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        check_size(mc.shape[-1], sum(self.split_sections),
                   "dimension of mel-cepstrum")
        check_size(x.shape[-1], mc.shape[-2] * self.frame_period,
                   "sequence length")
        if len(self.split_sections) != 1:
            n = self.split_sections[0]
            mc_max, mc_min = mc[..., :n], mc[..., n:]
            mc_max = torch.nn.functional.pad(torch.flip(mc_max, (-1,)),
                                             (1, 0))
            mc_inner = (mc_min, mc_max)
        else:
            mc_inner = mc
        return self.mglsadf(x, mc_inner)


class PseudoInverseMGLSADigitalFilter(nn.Module):
    """IMLSA: literally mglsadf(y, -mc)."""

    def __init__(self, filter_order, frame_period: int, **kwargs) -> None:
        super().__init__()
        self.mglsadf = PseudoMGLSADigitalFilter(filter_order, frame_period,
                                                **kwargs)

    def forward(self, y: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        return self.mglsadf(y, -mc)
