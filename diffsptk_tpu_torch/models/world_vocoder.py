"""WORLD vocoder pipeline (counterpart of
``diffsptk_tpu/models/world_vocoder.py``): pitch -> aperiodicity ->
spectral envelope -> synthesis, as one module.

Gradients flow through the waveform analysis and the synthesis but not
through F0.  On the card in float32 the analysis's windowed reads run the
windowed-gather kernel and the synthesis's overlap-add the overlap-add
kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core import child, full_precision, place
from ..ops.ap import Aperiodicity
from ..ops.pitch import Pitch
from ..ops.pitch_spec import PitchAdaptiveSpectralAnalysis
from ..ops.world_synth import WorldSynthesis


class WorldVocoder(nn.Module):
    """WORLD analysis-synthesis.

    Parameters mirror the stage ops; pass stage-specific extras via
    ``pitch_kwargs`` / ``ap_kwargs`` / ``spec_kwargs`` / ``synth_kwargs``.
    """

    def __init__(self, frame_period: int = 80, sample_rate: int = 16000,
                 fft_length: int = 1024, *,
                 pitch_algorithm: str = "yin",
                 ap_algorithm: str = "tandem",
                 spec_algorithm: str = "cheap-trick",
                 f_min: float = 60.0, f_max: float = 500.0,
                 pitch_kwargs: dict | None = None,
                 ap_kwargs: dict | None = None,
                 spec_kwargs: dict | None = None,
                 synth_kwargs: dict | None = None,
                 dtype=None, device=None) -> None:
        super().__init__()
        self.pitch = child(Pitch, frame_period=frame_period,
                           sample_rate=sample_rate,
                           algorithm=pitch_algorithm, out_format="f0",
                           f_min=f_min, f_max=f_max, **(pitch_kwargs or {}))
        self.ap = child(Aperiodicity, frame_period=frame_period,
                        sample_rate=sample_rate, fft_length=fft_length,
                        algorithm=ap_algorithm, **(ap_kwargs or {}))
        self.spec = child(PitchAdaptiveSpectralAnalysis,
                          frame_period=frame_period, sample_rate=sample_rate,
                          fft_length=fft_length, algorithm=spec_algorithm,
                          **(spec_kwargs or {}))
        self.synth = child(WorldSynthesis, frame_period=frame_period,
                           sample_rate=sample_rate, fft_length=fft_length,
                           f0_ceil=max(f_max, 500.0) * 1.2, f0_floor=f_min,
                           **(synth_kwargs or {}))
        place(self, device, dtype)

    @full_precision
    def analyze(self, x: torch.Tensor, even_frames: bool = False):
        """Waveform (..., T) -> (f0, aperiodicity, envelope), T // P + 1
        frames; ``even_frames=True`` drops the final edge frame (T // P
        frames)."""
        f0 = self.pitch(x)
        if even_frames:
            f0 = f0[..., : x.shape[-1] // self.synth.frame_period]
        ap = self.ap(x, f0)
        sp = self.spec(x, f0)
        return f0, ap, sp

    @full_precision
    def synthesize(self, f0, ap, sp, out_length: int | None = None):
        return self.synth(f0, ap, sp, out_length=out_length)

    @full_precision
    def analysis_synthesis(self, x: torch.Tensor) -> torch.Tensor:
        f0, ap, sp = self.analyze(x)
        return self.synthesize(f0, ap, sp, out_length=x.shape[-1])
