"""Flagship pipeline: STFT -> mcep -> (I)MLSA analysis-synthesis
(counterpart of ``diffsptk_tpu/models/mcep_vocoder.py``).

On the card in float32 the Newton solves of the analysis run the Newton
kernel, and with ``cascade="fused"`` both Taylor cascades of the
synthesis run the cascade kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import child, full_precision, place
from ..ops.mcep import MelCepstralAnalysis
from ..ops.mglsadf import (
    PseudoInverseMGLSADigitalFilter,
    PseudoMGLSADigitalFilter,
)
from ..ops.stft import ShortTimeFourierTransform


class MelCepstralVocoder(nn.Module):
    """Analysis (mel-cepstrum extraction) and synthesis (MLSA filtering)."""

    def __init__(self, *, frame_length: int = 400, frame_period: int = 80,
                 fft_length: int = 512, cep_order: int = 24,
                 alpha: float = 0.42, n_iter: int = 10,
                 taylor_order: int = 20, cep_order_mlsa: int = 199,
                 mode: str = "multi-stage",
                 cascade: str = "folded",
                 cascade_precision: str | None = None,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.frame_period = frame_period
        self.stft = child(
            ShortTimeFourierTransform, frame_length=frame_length,
            frame_period=frame_period, fft_length=fft_length, eps=0,
            relative_floor=-80, out_format="power")
        self.mcep = child(
            MelCepstralAnalysis, fft_length=fft_length, cep_order=cep_order,
            alpha=alpha, n_iter=n_iter)
        kwargs: dict = dict(alpha=alpha, mode=mode)
        if mode in ("multi-stage", "pade-approx"):
            kwargs["cep_order"] = cep_order_mlsa
        if mode == "multi-stage":
            kwargs["taylor_order"] = taylor_order
            kwargs["cascade"] = cascade
            if cascade_precision is not None:
                kwargs["cascade_precision"] = cascade_precision
        self.mlsa = child(PseudoMGLSADigitalFilter, filter_order=cep_order,
                          frame_period=frame_period, **kwargs)
        self.imlsa = child(PseudoInverseMGLSADigitalFilter,
                           filter_order=cep_order,
                           frame_period=frame_period, **kwargs)
        place(self, device, dtype)

    @full_precision
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform (..., T) -> mel-cepstrum (..., T/P, M+1)."""
        return self.mcep(self.stft(x))

    @full_precision
    def synthesize(self, e: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        """Excitation + mel-cepstrum -> waveform."""
        return self.mlsa(e, mc)

    @full_precision
    def analysis_synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """Full round trip: extract mc, inverse-filter to excitation,
        re-synthesize."""
        mc = self.analyze(x)
        T = mc.shape[-2] * self.frame_period
        e = self.imlsa(x[..., :T], mc)
        return self.mlsa(e, mc)
