"""Sharded mel-cepstral vocoder: the flagship chain (STFT -> mcep Newton ->
MLSA analysis-synthesis) over a (dp, tp) mesh (counterpart of
``diffsptk_tpu/parallel/vocoder.py``).

The time split is exact, not warmup-approximate: every stage of the MLSA
Taylor cascade is a time-varying FIR whose frame-blocked form needs only
a few frames of halo on each side, after which the stage runs block-local
(``kernels/mlsa_cascade.stage_apply``).  The mcep Newton solves and the
window and spectrum stages are frame-parallel, with no communication; on
the card in float32 the solves take the Newton kernel (B1), ten launches
an analysis.  The N-rank output equals the one-rank output up to the
order of float sums (tests/test_torch_parallel_vocoder.py).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import full_precision
from ..kernels.mlsa_cascade import (
    coef_spectrum,
    lane_aligned_nfft,
    stage_apply,
    stage_plans,
)
from ..ops.mcep import MelCepstralAnalysis
from ..ops.mgc2mgc import MelGeneralizedCepstrumToMelGeneralizedCepstrum
from ..ops.mglsadf import _exp_taylor_weights
from ..ops.stft import ShortTimeFourierTransform
from ..utils.linalg import remove_gain
from .halo import exchange_halo
from .mesh import Axis
from .sharded import sharded_frame


class ShardedMelCepstralVocoder:
    """Mel-cepstral analysis-synthesis over a (dp, tp) mesh.

    Each rank passes its block: a waveform (B/n_dp, T/n_tp), or
    mel-cepstra (B/n_dp, T/(P n_tp), M+1), and receives its block of the
    result.  The local T must be a multiple of frame_period, and the
    local frame count at least the MLSA stage's frame halo (4 at the
    flagship's P=80, M=199; the bulk halo needs S * 4).  Operators are
    built on ``device`` in ``dtype`` as every operator of the port."""

    def __init__(self, mesh: DeviceMesh, *, frame_length: int = 400,
                 frame_period: int = 80, fft_length: int = 512,
                 cep_order: int = 24, alpha: float = 0.42, n_iter: int = 10,
                 taylor_order: int = 20, cep_order_mlsa: int = 199,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp",
                 dtype=None, device=None) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.frame_length = frame_length
        self.frame_period = frame_period
        place = dict(dtype=dtype, device=device)
        self.stft = ShortTimeFourierTransform(
            frame_length, frame_period, fft_length, eps=0,
            relative_floor=-80, out_format="power", **place)
        self.mcep = MelCepstralAnalysis(
            fft_length=fft_length, cep_order=cep_order, alpha=alpha,
            n_iter=n_iter, **place)
        self.mgc2c = MelGeneralizedCepstrumToMelGeneralizedCepstrum(
            cep_order, cep_order_mlsa, in_alpha=alpha, n_fft=512, **place)
        self.cep_order_mlsa = cep_order_mlsa
        self.taylor_order = taylor_order
        self.taylor_weights = [float(w)
                               for w in _exp_taylor_weights(taylor_order)]

    # ---------------------------------------------------------------- local
    def _axis(self) -> Axis:
        return Axis(self.mesh, self.tp)

    def _local_analysis(self, x: torch.Tensor) -> torch.Tensor:
        frames = sharded_frame(x, self.frame_length, self.frame_period,
                               self.mesh, self.tp)
        X = self.stft.spec(self.stft.window(frames))
        return self.mcep(X)                     # frame-parallel Newton

    def _stage_setup(self, mc: torch.Tensor, left: int, right: int):
        """The stage coefficients' spectra over the local frames extended
        by ``left`` and ``right + 1`` frames (edge-replicated at the
        global ends), and the gain track with one frame to the right."""
        P, M = self.frame_period, self.cep_order_mlsa
        tp = self._axis()
        c0, c = remove_gain(self.mgc2c(mc), value=0.0, return_gain=True)
        # the lerp's upper bracket of the last local frame is the right
        # neighbour's first filter
        c_ext = exchange_halo(c, left, right + 1, tp, axis=-2,
                              pad_mode="edge")
        c0_ext = exchange_halo(c0, 0, 1, tp, axis=-2, pad_mode="edge")
        nfft = lane_aligned_nfft(2 * P + M + 1)
        cre, cim = coef_spectrum(c_ext, nfft)
        return nfft, cre, cim, c0_ext

    def _gain(self, c0_ext: torch.Tensor, shape) -> torch.Tensor:
        """e^{c0}, interpolated linearly across each frame."""
        P = self.frame_period
        lam = torch.arange(P, dtype=c0_ext.dtype, device=c0_ext.device) / P
        k_lo = c0_ext[..., :-1, 0, None]
        k_hi = c0_ext[..., 1:, 0, None]
        return torch.exp(k_lo * (1 - lam) + k_hi * lam).reshape(shape)

    def _local_mlsa(self, x: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
        """One MLSA multi-stage filter on the local block, exact across
        block boundaries by a frame-halo exchange at every stage."""
        P, M = self.frame_period, self.cep_order_mlsa
        n_local = mc.shape[-2]
        tp = self._axis()
        nfft, cre, cim, c0_ext = self._stage_setup(mc, 0, 0)
        # the halo moves to the frame axis: r0 rows left and n_blk - r0
        # right cover the (P + M, P)-sample reach of a stage
        _, _, _, r0, n_blk = stage_plans(nfft, M, P)

        def stage(xin):
            xq = xin.reshape(*xin.shape[:-1], n_local, P)
            xq_ext = exchange_halo(xq, r0, n_blk - r0, tp, axis=-2)
            return stage_apply(xq_ext, cre, cim, nfft, M, P).reshape(
                xin.shape)

        y = xi = x
        for i in range(1, self.taylor_order + 1):
            xi = stage(xi) * self.taylor_weights[i]
            y = y + xi
        return y * self._gain(c0_ext, x.shape)

    def _local_mlsa_bulk(self, x: torch.Tensor,
                         mc: torch.Tensor) -> torch.Tensor:
        """The same filter with ONE halo exchange for all S stages.

        The block is extended once by the whole S-stage reach (frame
        aligned: S * ceil((P + M) / P) frames left, S frames right) and
        every stage runs on the extended buffer, imposing the global zero
        padding between stages (``inside``) so that the edges are those of
        the per-stage path.  The price is redundant edge work, about
        S (2P + M) samples a rank."""
        P, M, S = self.frame_period, self.cep_order_mlsa, self.taylor_order
        n_local = mc.shape[-2]
        tp = self._axis()
        T_l = x.shape[-1]
        hl_f = S * (-(-(P + M) // P))
        hr_f = S
        hl, hr = hl_f * P, hr_f * P
        nfft, cre, cim, c0_ext = self._stage_setup(mc, hl_f, hr_f)
        x_ext = exchange_halo(x, hl, hr, tp)
        n_ext = n_local + hl_f + hr_f
        pos = (torch.arange(T_l + hl + hr, device=x.device) - hl
               + tp.index * T_l)
        inside = ((pos >= 0) & (pos < T_l * tp.size)).to(x.dtype)
        _, _, _, r0, n_blk = stage_plans(nfft, M, P)

        def stage(xin):
            xq = xin.reshape(*xin.shape[:-1], n_ext, P)
            xq = torch.nn.functional.pad(xq, (0, 0, r0, n_blk - r0))
            y = stage_apply(xq, cre, cim, nfft, M, P)
            return y.reshape(xin.shape) * inside

        y = xi = x_ext * inside
        for i in range(1, S + 1):
            xi = stage(xi) * self.taylor_weights[i]
            y = y + xi
        return y[..., hl:hl + T_l] * self._gain(c0_ext, x.shape)

    # ---------------------------------------------------------------- public
    def _check_t(self, T_local: int) -> None:
        if T_local % self.frame_period:
            raise ValueError(
                "T must be divisible by frame_period * n_time_shards.")

    @full_precision
    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """Local waveform block -> its mel-cepstra (..., T_l/P, M+1)."""
        self._check_t(x.shape[-1])
        return self._local_analysis(x)

    @full_precision
    def synthesize(self, e: torch.Tensor, mc: torch.Tensor,
                   halo: str = "per-stage") -> torch.Tensor:
        """``halo``: "per-stage" (one small exchange a stage) or "bulk"
        (one exchange and redundant edge work; see _local_mlsa_bulk)."""
        self._check_t(e.shape[-1])
        if halo not in ("per-stage", "bulk"):
            raise ValueError(f"halo {halo} is not supported.")
        fn = self._local_mlsa_bulk if halo == "bulk" else self._local_mlsa
        return fn(e, mc)

    @full_precision
    def analysis_synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """The local block of the round trip: analysis, inverse MLSA to the
        excitation, MLSA back."""
        self._check_t(x.shape[-1])
        mc = self._local_analysis(x)
        e = self._local_mlsa(x, -mc)
        return self._local_mlsa(e, mc)
