"""Mel-cepstrum power utilities: pnorm/ipnorm, the HTS postfilter (mcpf)
and the MLSA stability check (counterpart of ``diffsptk_tpu/ops/mcpf.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size, child, filter_values
from .cep import CepstrumToAutocorrelation
from .freqt import FrequencyTransform
from .mc2b import (
    MelCepstrumToMLSADigitalFilterCoefficients,
    MLSADigitalFilterCoefficientsToMelCepstrum,
)


def _power_layers(cep_order: int, alpha: float, ir_length: int) -> dict:
    """The children that measure a mel-cepstrum's power: warp to a plain
    cepstrum of ir_length taps, then the zeroth autocorrelation."""
    return {
        "freqt": child(FrequencyTransform, in_order=cep_order,
                       out_order=ir_length - 1, alpha=-alpha),
        "c2acr": child(CepstrumToAutocorrelation, cep_order=ir_length - 1,
                       acr_order=0, n_fft=ir_length),
    }


class MelCepstrumPowerNormalization(BaseOp):
    """mc (..., M+1) -> [log power, power-normalized mc] (..., M+2)."""

    def __init__(self, cep_order: int, alpha: float = 0,
                 ir_length: int = 128, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _design(cep_order: int, alpha: float = 0,
                ir_length: int = 128) -> Design:
        return Design(layers=_power_layers(cep_order, alpha, ir_length))

    @staticmethod
    def _forward(x: torch.Tensor, *, freqt, c2acr) -> torch.Tensor:
        x0, x1 = x[..., :1], x[..., 1:]
        P = torch.log(c2acr(freqt(x)))
        return torch.cat((P, x0 - 0.5 * P, x1), dim=-1)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(x)


class MelCepstrumInversePowerNormalization(BaseOp):
    """Inverse of :class:`MelCepstrumPowerNormalization`."""

    def __init__(self, cep_order: int, dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 2
        self._setup(self._design(cep_order), dtype=dtype, device=device)

    @staticmethod
    def _check(cep_order: int) -> None:
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")

    @staticmethod
    def _design(cep_order: int = 0) -> Design:
        MelCepstrumInversePowerNormalization._check(cep_order)
        return Design()

    @staticmethod
    def _forward(y: torch.Tensor) -> torch.Tensor:
        P, y1, y2 = y[..., :1], y[..., 1:2], y[..., 2:]
        return torch.cat((0.5 * P + y1, y2), dim=-1)

    def forward(self, y):
        check_size(y.shape[-1], self.in_dim, "dimension of input")
        return super().forward(y)


class MelCepstrumPostfiltering(BaseOp):
    """HTS-style formant postfilter."""

    def __init__(self, cep_order: int, alpha: float = 0, beta: float = 0,
                 onset: int = 2, ir_length: int = 128, dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(onset: int) -> None:
        if onset < 0:
            raise ValueError("onset must be non-negative.")

    @staticmethod
    def _design(cep_order: int, alpha: float = 0, beta: float = 0,
                onset: int = 2, ir_length: int = 128) -> Design:
        MelCepstrumPostfiltering._check(onset)
        layers = _power_layers(cep_order, alpha, ir_length)
        layers["mc2b"] = child(MelCepstrumToMLSADigitalFilterCoefficients,
                               cep_order=cep_order, alpha=alpha)
        layers["b2mc"] = child(MLSADigitalFilterCoefficientsToMelCepstrum,
                               cep_order=cep_order, alpha=alpha)
        weight = np.full(cep_order + 1, 1.0 + beta)
        weight[:onset] = 1.0
        return Design(layers=layers, arrays={"weight": weight})

    @staticmethod
    def _forward(mc: torch.Tensor, *, freqt, c2acr, mc2b, b2mc,
                 weight: torch.Tensor) -> torch.Tensor:
        e1 = c2acr(freqt(mc))
        mc2 = mc * weight
        e2 = c2acr(freqt(mc2))
        b2 = mc2b(mc2)
        b2 = torch.cat((b2[..., :1] + 0.5 * torch.log(e1 / e2), b2[..., 1:]),
                       dim=-1)
        return b2mc(b2)

    def forward(self, mc):
        check_size(mc.shape[-1], self.in_dim, "dimension of cepstrum")
        return super().forward(mc)


class MLSADigitalFilterStabilityCheck(BaseOp):
    """Check and repair mel-cepstra against the Pade stability threshold.

    ``warn_type`` is kept for the JAX package's signature; like it, the
    check repairs and never reads the result back to warn.
    """

    def __init__(self, cep_order: int, *, alpha: float = 0,
                 pade_order: int = 4, strict: bool = True,
                 threshold: float | None = None, fast: bool = True,
                 n_fft: int = 256, warn_type: str = "warn",
                 mod_type: str = "scale", dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = cep_order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(cep_order: int) -> None:
        if cep_order < 0:
            raise ValueError("cep_order must be non-negative.")

    @staticmethod
    def _design(cep_order: int, alpha: float = 0, pade_order: int = 4,
                strict: bool = True, threshold: float | None = None,
                fast: bool = True, n_fft: int = 256,
                warn_type: str = "warn", mod_type: str = "scale") -> Design:
        MLSADigitalFilterStabilityCheck._check(cep_order)
        if threshold is None:
            table = {4: (4.5, 6.20), 5: (6.0, 7.65), 6: (7.4, 9.13),
                     7: (8.9, 10.6)}
            if pade_order not in table:
                raise ValueError(f"pade_order {pade_order} is not supported.")
            threshold = table[pade_order][0 if strict else 1]
        alpha_vector = (-alpha) ** np.arange(cep_order + 1)
        return Design(
            values={"threshold": threshold, "fast": fast, "n_fft": n_fft,
                    "warn_type": warn_type, "mod_type": mod_type},
            arrays={"alpha_vector": alpha_vector})

    @staticmethod
    def _forward(mc: torch.Tensor, *, threshold: float, fast: bool,
                 n_fft: int, warn_type: str, mod_type: str,
                 alpha_vector: torch.Tensor) -> torch.Tensor:
        gain = torch.sum(mc * alpha_vector, dim=-1, keepdim=True)
        if fast:
            if mod_type == "clip":
                raise ValueError("clip is not supported in fast mode.")
            max_amplitude = torch.sum(mc, dim=-1, keepdim=True) - gain
        else:
            c1 = torch.cat((mc[..., :1] - gain, mc[..., 1:]), dim=-1)
            C1 = torch.fft.rfft(c1, n=n_fft)
            C1_amplitude = torch.abs(C1)
            max_amplitude = torch.amax(C1_amplitude, dim=-1, keepdim=True)
        max_amplitude = torch.clamp(max_amplitude, min=1e-16)

        if mod_type == "clip":
            scale = threshold / C1_amplitude
        elif mod_type == "scale":
            scale = threshold / max_amplitude
        else:
            raise ValueError(f"mod_type {mod_type} is not supported.")
        scale = torch.clamp(scale, max=1)

        if fast:
            c0, c1 = mc[..., :1], mc[..., 1:]
            return torch.cat(((c0 - gain) * scale + gain, c1 * scale),
                             dim=-1)
        c2 = torch.fft.irfft(C1 * scale)[..., : mc.shape[-1]]
        return torch.cat((c2[..., :1] + gain, c2[..., 1:]), dim=-1)

    def forward(self, mc):
        check_size(mc.shape[-1], self.in_dim, "dimension of mel-cepstrum")
        return super().forward(mc)
