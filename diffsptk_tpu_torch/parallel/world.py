"""Sharded WORLD vocoder: the analysis-synthesis chain (YIN pitch ->
TANDEM aperiodicity -> CheapTrick envelope -> pulse and noise synthesis)
over a (dp, tp) mesh (counterpart of ``diffsptk_tpu/parallel/world.py``).

Every framed analysis stage becomes block-local after one halo exchange.
The two global pieces of WORLD are (a) the excitation phase integral, a
cumulative sum over all T, taken as local sums plus an all-gathered prefix
of the other ranks' sums, and (b) the overlap-add of the pulse
responses, whose spills into the neighbours' blocks ride one exchange.
The synthesis noise is keyed per pulse by its global sample position and
global batch row (ops/world_synth.py), so the sharded chain reproduces
the one-rank output up to the order of float sums.

On the card in float32 TANDEM's windowed reads take the gather kernel
(B6, four launches a call), the overlap-add the overlap-add kernel (B7,
one a call) and the slot noise the threefry kernel (one a call).

Halo widths per stage:
  pitch:       (Lyin/2, Lyin) samples, Lyin = window_length + tau_max
  tandem:      TANDEM_HALO samples each side (the QMF cascade's transients
               plus the worst-case window overhang in every band)
  cheap-trick: fft_length/2 each side (centred framing)
  synthesis:   one frame of (f0, ap, sp) to the right; overlap-add spills
               of fft_length/2 (left) and fft_length (right) samples
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..core import full_precision
from ..kernels.ola import overlap_add
from ..ops.ap import AperiodicityExtractionByTANDEM
from ..ops.pitch import PitchExtractionByYIN
from ..ops.pitch_spec import SpectrumExtractionByCheapTrick
from ..ops.world_common import TAU
from ..ops.world_synth import WorldSynthesis, phase_units, units_to_phase
from .halo import exchange_halo
from .mesh import Axis, all_gather, neighbour_swap, swap

TANDEM_HALO = 2048


class ShardedWorldVocoder:
    """WORLD analysis-synthesis over a (dp, tp) mesh.

    Each rank passes its block: a waveform (B/n_dp, T/n_tp), or
    (f0 (B/n_dp, N/n_tp), ap and sp (B/n_dp, N/n_tp, D)) with N = T/P,
    and receives its block of the result.  The local T must be a multiple
    of frame_period and at least max(TANDEM_HALO, fft_length) + 1.
    Operators are built on ``device`` in ``dtype`` as every operator of
    the port."""

    def __init__(self, mesh: DeviceMesh, frame_period: int = 80,
                 sample_rate: int = 16000, fft_length: int = 1024, *,
                 f_min: float = 60.0, f_max: float = 500.0,
                 ap_floor: float = 0.001, ap_ceil: float = 0.999,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp",
                 pitch_kwargs: dict | None = None,
                 ap_kwargs: dict | None = None,
                 spec_kwargs: dict | None = None,
                 synth_kwargs: dict | None = None,
                 dtype=None, device=None) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.fft_length = fft_length
        self.ap_floor = ap_floor
        self.ap_ceil = ap_ceil
        place = dict(dtype=dtype, device=device)
        self.pitch = PitchExtractionByYIN(
            frame_period, sample_rate, f_min=f_min, f_max=f_max,
            **(pitch_kwargs or {}))
        self.ap = AperiodicityExtractionByTANDEM(
            frame_period, sample_rate, fft_length, **(ap_kwargs or {}),
            **place)
        self.spec = SpectrumExtractionByCheapTrick(
            frame_period, sample_rate, fft_length, **(spec_kwargs or {}),
            **place)
        self.synth = WorldSynthesis(
            frame_period, sample_rate, fft_length,
            f0_ceil=max(f_max, 500.0) * 1.2, f0_floor=f_min,
            **(synth_kwargs or {}), **place)

    # ---------------------------------------------------------------- local
    def _local_pitch(self, x: torch.Tensor) -> torch.Tensor:
        Lf = self.pitch.window_length + self.pitch.tau_max
        # the unsharded op zero-pads (Lf // 2, Lf) around the signal
        x_ext = exchange_halo(x, Lf // 2, Lf, Axis(self.mesh, self.tp))
        frames = x_ext.unfold(-1, Lf, self.frame_period)
        frames = frames[..., :x.shape[-1] // self.frame_period, :]
        return self.pitch.calc_pitch(None, frames=frames).detach()

    def _local_ap(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        T_l = x.shape[-1]
        n_band = self.ap.n_band
        if T_l % (2 ** (n_band - 1)):
            raise ValueError(
                f"local block length must be divisible by 2**{n_band - 1}.")
        h = TANDEM_HALO
        tp = Axis(self.mesh, self.tp)
        x_ext = exchange_halo(x, h, h, tp, pad_mode="reflect")
        n0 = tp.index * (T_l // self.frame_period)
        base0 = tp.index * T_l - h      # global sample index of x_ext[0]
        levels = [min(i + 1, n_band - 1) for i in range(n_band)]
        band_bases = [base0 // (2 ** lv) for lv in levels]

        def edges(hw: int, Tb: int) -> tuple[int, int]:
            """The valid band samples [lv, rv): the halo beyond the global
            edges lies outside them on the edge ranks."""
            return (hw if tp.first else 0), (Tb - hw if tp.last else Tb)

        def band_fix(xb, i):
            # Beyond the global edges the unsharded op clamps its reads
            # of the band signal (edge replicate), while the reflect halo
            # holds mirrored values: overwrite them with the boundary
            # value.  (The QMF filters are symmetric, so elsewhere the
            # mirrored halo equals the cascade's own reflect padding.)
            Tb = xb.shape[-1]
            lv, rv = edges(h >> levels[i], Tb)
            parts = [xb[..., lv:lv + 1].expand(*xb.shape[:-1], lv),
                     xb[..., lv:rv],
                     xb[..., rv - 1:rv].expand(*xb.shape[:-1], Tb - rv)]
            return torch.cat(parts, dim=-1)

        def carry_fix(sig, level):
            # Re-mirror the halo beyond the global edges with this level's
            # own reflect convention (numpy reflect about the first / last
            # valid sample), so that the next decimation sees what the
            # unsharded cascade's padding gives it.
            Tb = sig.shape[-1]
            lv, rv = edges(h >> level, Tb)
            pos = torch.arange(Tb, device=sig.device)
            idx = torch.where(pos < lv, 2 * lv - pos, pos)
            idx = torch.where(pos >= rv, 2 * rv - 2 - pos, idx)
            idx = torch.clamp(idx, 0, Tb - 1)
            return sig[..., idx]

        ap = self.ap(x_ext, f0, n_offset=n0, band_bases=band_bases,
                     band_fix=band_fix, carry_fix=carry_fix)
        return torch.clamp(ap, self.ap_floor, self.ap_ceil)

    def _local_sp(self, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        L = self.fft_length
        # centred, replicate-padded framing (world_common's framing)
        x_ext = exchange_halo(x, L // 2, L // 2, Axis(self.mesh, self.tp),
                              pad_mode="edge")
        frames = x_ext.unfold(-1, L, self.frame_period)[..., :f0.shape[-1], :]
        return torch.exp(self.spec(None, f0, frames=frames))

    def _local_synth(self, f0: torch.Tensor, ap: torch.Tensor,
                     sp: torch.Tensor) -> torch.Tensor:
        synth = self.synth
        P, sr, L = self.frame_period, self.sample_rate, self.fft_length
        H = L // 2
        B, N_l, D = sp.shape
        T_l = N_l * P
        if T_l < L:
            raise ValueError("local block must be at least fft_length.")
        tp = Axis(self.mesh, self.tp)
        t_start = tp.index * T_l
        T_g = T_l * tp.size
        dev = sp.device

        eps = 1e-6
        ap = torch.clamp(ap, eps, 1 - eps)
        sp = torch.clamp(sp, min=eps)

        # frame -> sample upsampling, with one frame of right halo
        f_min = sr / L + 1
        coarse_f0 = torch.where(f0 < f_min, torch.zeros_like(f0), f0).detach()
        coarse_vuv = (0 < coarse_f0).to(coarse_f0.dtype)
        cf0 = exchange_halo(coarse_f0, 0, 1, tp, pad_mode="edge")
        cvuv = exchange_halo(coarse_vuv, 0, 1, tp, pad_mode="edge")
        wt = torch.arange(P, dtype=f0.dtype, device=dev)[None, :] / P

        def upsample(c):
            out = c[..., :N_l, None] * (1 - wt) + c[..., 1:, None] * wt
            return out.reshape(*c.shape[:-1], T_l)

        interp_f0 = upsample(cf0)
        interp_vuv = upsample(cvuv) > 0.5
        interp_f0 = torch.where(interp_vuv, interp_f0,
                                torch.full_like(interp_f0, synth.default_f0))

        # the global phase integral in fixed point (ops/world_synth.py):
        # the phase reads only the low 22 (float32) or 52 (float64) bits
        # of the unit sums, which the int64 sums that torch takes keep
        # exactly however they wrap, so a local cumulative sum plus the
        # all-gathered sums of the ranks to the left is the one-rank one
        units = phase_units(TAU / sr * interp_f0)        # (B, T_l)
        bits = 52 if units.dtype == torch.int64 else 22
        units_ext = exchange_halo(units, 0, 1, tp)
        sums = all_gather(units.sum(-1, dtype=torch.int64), tp)  # (S, B)
        prefix = sums[:tp.index].sum(0)
        total = torch.cumsum(units_ext, -1, dtype=torch.int64) + prefix[:,
                                                                       None]
        wrap_ext = units_to_phase(total, bits, sp.dtype)  # (B, T_l + 1)
        dphase = torch.abs(torch.diff(wrap_ext, dim=-1))  # (B, T_l)
        pulse_mask = np.pi < dphase

        # the local slot table, built as the unsharded op builds it
        min_period = max(int(sr / synth.f0_ceil), 1)
        max_p = T_l // min_period + 2
        csum = torch.cumsum(pulse_mask.to(torch.int32), dim=-1,
                            dtype=torch.int32)
        wanted = torch.arange(1, max_p + 1, dtype=torch.int32,
                              device=dev).expand(B, -1).contiguous()
        time_index = torch.searchsorted(csum, wanted, side="left")
        n_pulses = csum[:, -1]
        valid = (torch.arange(max_p, device=dev)[None, :]
                 < n_pulses[:, None])
        last_valid = torch.amax(
            torch.where(valid, time_index, torch.zeros_like(time_index)),
            dim=-1, keepdim=True)

        # the pulse after a rank's last one lies on its right neighbour:
        # fetch that one's first pulse, so that the last pulse's noise
        # spans what it spans unsharded
        first = torch.cat([time_index[:, :1],
                           (n_pulses > 0).to(time_index.dtype)[:, None]], -1)
        _, nxt = neighbour_swap(None, first, tp)
        if tp.last:
            nxt_rel = last_valid
        else:
            nxt_rel = torch.where(nxt[:, 1:] > 0, nxt[:, :1] + T_l,
                                  last_valid)
        noise_index = torch.where(valid, time_index, nxt_rel)
        noise_size = torch.clamp(torch.diff(
            torch.cat([noise_index, nxt_rel], -1), dim=-1), min=0)
        ti = torch.where(valid, time_index, torch.zeros_like(time_index))

        vuv = torch.gather(interp_vuv.to(sp.dtype), 1, ti)[..., None]
        y1 = torch.gather(wrap_ext, 1, ti) - TAU
        y2 = torch.gather(wrap_ext, 1, ti + 1)
        time_shift = -y1 / (y2 - y1) / sr

        # the envelope and aperiodicity at each pulse: frame
        # interpolation with one frame of right halo (the global clamp is
        # the edge fill on the last rank)
        sp_ext = exchange_halo(sp, 0, 1, tp, axis=-2, pad_mode="edge")
        ap_ext = exchange_halo(ap, 0, 1, tp, axis=-2, pad_mode="edge")
        frame = ((t_start + ti).to(sp.dtype) / sr * (sr / P)
                 - tp.index * N_l)
        f_floor = torch.clamp(torch.floor(frame).long(), 0, N_l)
        f_ceil = torch.clamp(torch.ceil(frame).long(), 0, N_l)
        w_hi = (frame - f_floor)[..., None]
        w_lo = 1 - w_hi
        bidx = torch.arange(B, device=dev)[:, None]
        env = w_lo * sp_ext[bidx, f_floor] + w_hi * sp_ext[bidx, f_ceil]
        apr = (w_lo * ap_ext[bidx, f_floor]
               + w_hi * ap_ext[bidx, f_ceil]) ** 2

        response = synth._slot_responses(
            env, apr, vuv, time_shift, noise_size[..., None].to(sp.dtype),
            valid, t_start + ti, span=T_g,
            batch_offset=Axis(self.mesh, self.dp).index * B)

        # the local overlap-add (its slot table nondecreasing: an invalid
        # slot, whose response is zero, repeats the last valid start),
        # then the spills into the neighbours' blocks
        starts = torch.where(valid, time_index, last_valid)
        buf = overlap_add(starts, response, T_l + L, check=False)
        from_left, from_right = swap(buf[:, T_l:T_l + L], buf[:, :H], tp)
        y = buf[:, H:H + T_l]
        return (y + F.pad(from_left[:, H:], (0, T_l - H))
                + F.pad(from_right, (T_l - H, 0)))

    # ---------------------------------------------------------------- public
    def _check_t(self, T_local: int) -> None:
        if T_local % self.frame_period:
            raise ValueError(
                "T must be divisible by frame_period * n_time_shards.")
        if T_local <= max(TANDEM_HALO, self.fft_length):
            raise ValueError(
                "local block must be longer than "
                f"max(TANDEM_HALO, fft_length) = "
                f"{max(TANDEM_HALO, self.fft_length)} samples.")

    @full_precision
    def analyze(self, x: torch.Tensor):
        """Local waveform block -> its (f0, ap, sp) frames."""
        self._check_t(x.shape[-1])
        f0 = self._local_pitch(x)
        return f0, self._local_ap(x, f0), self._local_sp(x, f0)

    @full_precision
    def synthesize(self, f0, ap, sp):
        """Local (f0, ap, sp) frames -> the local waveform block."""
        self._check_t(sp.shape[-2] * self.frame_period)
        return self._local_synth(f0, ap, sp)

    @full_precision
    def analysis_synthesis(self, x: torch.Tensor) -> torch.Tensor:
        self._check_t(x.shape[-1])
        f0 = self._local_pitch(x)
        return self._local_synth(f0, self._local_ap(x, f0),
                                 self._local_sp(x, f0))
