"""WORLD synthesis (counterpart of ``diffsptk_tpu/ops/world_synth.py``).

Pulses live in a fixed-size slot table of ``max_pulses = T / min_period``
entries per batch row: the pulse mask's running count assigns each pulse
its slot (a batched binary search), every per-pulse response (minimum
phase spectra, fractional shift, noise) is computed batched over slots
with invalid slots masked, and one overlap-add of (B, max_pulses,
fft_length) into (B, T + margin) ends it, through the overlap-add kernel
(kernels/ola.py).

The per-slot noise is the JAX package's counter-keyed stream: slot (b, p)
draws under ``fold_in(PRNGKey(seed), b * span + time_index[b, p])``, so it
does not depend on how the slot table is laid out (the threefry kernel on
the card in float32, kernels/threefry.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core import full_precision, place
from ..kernels import threefry
from ..kernels.ola import overlap_add
from .world_common import TAU, noise_dft_plans, synthesis_response_plans

_PHASE_BITS = 22      # float32: TAU = 2^22 units, low 22 bits kept
_PHASE_BITS64 = 52    # float64: TAU = 2^52 int64 units (wraps mod 2^64)


def phase_units(rate: torch.Tensor) -> torch.Tensor:
    """Per-sample phase increments in fixed-point units: 2^52 per TAU in
    int64 for float64 rates, 2^22 per TAU for float32 ones.  Both scales
    divide the integer modulus, so the wrapped phase is exact and does not
    depend on the order of the sums."""
    if rate.dtype == torch.float64:
        return torch.round(rate * (float(1 << _PHASE_BITS64) / TAU)).to(
            torch.int64)
    return torch.round(rate * (float(1 << _PHASE_BITS) / TAU)).to(
        torch.int32)


def units_to_phase(units: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    """Wrapped phase in [0, TAU) from (possibly overflowed) unit sums,
    ``bits`` the unit scale's exponent."""
    return (units & ((1 << bits) - 1)).to(dtype) * (TAU / float(1 << bits))


@functools.lru_cache(maxsize=16)
def _plans(L: int, Ln: int, dtype, device):
    """(noise cos, noise -sin, Hilbert, folded response) plans as tensors
    on ``device``, made once per device: a host-to-device copy in every
    call would stall the host."""
    plans = (*noise_dft_plans(Ln, L), *synthesis_response_plans(L))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in plans)


def _wrap_phase_fixed_point(rate: torch.Tensor) -> torch.Tensor:
    # The phase depends on the low 22 (float32) or 52 (float64) bits only,
    # so the int64 accumulator that torch.cumsum gives an int32 input
    # yields the same mask as JAX's wrapping int32 one.
    bits = _PHASE_BITS64 if rate.dtype == torch.float64 else _PHASE_BITS
    units = torch.cumsum(phase_units(rate), dim=-1, dtype=torch.int64)
    return units_to_phase(units, bits, rate.dtype)


class WorldSynthesis(nn.Module):
    """(f0 (B?, N), aperiodicity (B?, N, D), envelope (B?, N, D)) ->
    waveform (B?, N*P)."""

    def __init__(self, frame_period: int, sample_rate: int, fft_length: int,
                 *, default_f0: float = 500, f0_ceil: float = 1200.0,
                 f0_floor: float | None = None, seed: int = 0,
                 dtype=None, device=None) -> None:
        super().__init__()
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        if sample_rate < 8000:
            raise ValueError("sample_rate must be at least 8000 Hz.")
        if fft_length < 1024:
            raise ValueError("fft_length must be at least 1024.")
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.fft_length = fft_length
        self.default_f0 = default_f0
        self.f0_ceil = max(f0_ceil, default_f0)
        self.seed = seed

        # Per-pulse noise spans the gap to the next pulse, bounded by
        # sr/f0 of the lowest pulse rate: with a promised pitch floor the
        # noise table shrinks from fft_length to that bound (f0 below the
        # floor gets its noise segment truncated).
        if f0_floor is None:
            self.noise_length = fft_length
        else:
            if f0_floor <= 0:
                raise ValueError("f0_floor must be positive.")
            # + frame_period: at a voicing crossover the interpolated f0
            # dips to ~f0_floor/2 for at most one frame.
            bound = (int(round(sample_rate / min(f0_floor, default_f0)))
                     + frame_period + 2)
            self.noise_length = min(fft_length, -(-bound // 128) * 128)

        self.register_buffer("ramp", torch.arange(fft_length,
                                                  dtype=torch.float64))
        place(self, device, dtype)

    def _slot_noise(self, time_index: torch.Tensor, span: int,
                    batch_offset, length: int, dtype) -> torch.Tensor:
        """Per-slot Gaussian noise (B, Pmax, length) keyed by (global batch
        row, pulse position), the JAX package's stream: ``span`` is the
        counter stride between batch rows, ``batch_offset`` the global
        index of row 0."""
        return threefry.slot_normal(self.seed, time_index, span,
                                    batch_offset, length, dtype)

    def _slot_responses(self, env, apr, vuv, time_shift, noise_size,
                        valid, time_index_global, span: int,
                        batch_offset: int = 0) -> torch.Tensor:
        """Per-slot periodic + aperiodic responses (B, Pmax, L), already
        masked by slot validity: the core of the synthesis that does not
        depend on the sharding.  The noise is keyed by each pulse's global
        sample position ``time_index_global`` and global batch row (local
        row + ``batch_offset``); ``span`` is the global signal length, the
        counters' row stride (parallel/world.py)."""
        L = self.fft_length
        D = env.shape[-1]
        dt = env.dtype
        dev = env.device

        # GetNoiseSpectrum(): noise_length samples, zero-padded to L by
        # the real-DFT plans.
        Ln = self.noise_length
        noise = self._slot_noise(time_index_global, span=span,
                                 batch_offset=batch_offset, length=Ln,
                                 dtype=dt)
        Cn, Sn, Hm, Pfold = _plans(L, Ln, dt, dev)
        mask = self.ramp[:Ln] < noise_size
        noise = noise * mask
        avg = torch.sum(noise, dim=-1, keepdim=True) / torch.where(
            noise_size == 0, torch.ones_like(noise_size), noise_size)
        noise = (noise - avg) * mask
        nre = noise @ Cn
        nim = noise @ Sn

        # GetPeriodicResponse() + GetAperiodicResponse() + DC removal +
        # the vuv / noise_size / valid blend, folded into one (4K, L) plan:
        # magnitude exp(u), angle u @ H (discrete Hilbert transform).
        weight_p = 1 - apr
        weight_a = torch.where(0 < vuv, apr, torch.ones_like(apr))
        u = 0.5 * torch.log(torch.stack((weight_p, weight_a)) * env)
        ang = u @ Hm
        mag = torch.exp(u)
        coeff = TAU * self.sample_rate / L * time_shift
        th_p = ang[0] - self.ramp[:D] * coeff[..., None]
        # sqrt of the integer count in float32, as the JAX package takes
        # it (jnp.sqrt of an int32 array is float32 even under x64).
        s_p = ((0.5 < vuv) * torch.sqrt(noise_size.to(torch.float32))
               * valid[..., None] / L).to(dt)
        s_a = valid[..., None].to(dt) / L
        re_p = mag[0] * torch.cos(th_p) * s_p
        im_p = mag[0] * torch.sin(th_p) * s_p
        re_a = mag[1] * torch.cos(ang[1])
        im_a = mag[1] * torch.sin(ang[1])
        re_a, im_a = ((re_a * nre - im_a * nim) * s_a,
                      (re_a * nim + im_a * nre) * s_a)
        X = torch.cat([re_p, im_p, re_a, im_a], dim=-1)
        return X @ Pfold

    @full_precision
    def forward(self, f0, ap, sp, out_length: int | None = None):
        one_d = f0.ndim == 1
        if one_d:
            f0, ap, sp = f0[None], ap[None], sp[None]

        B, N, D = sp.shape
        P = self.frame_period
        T = N * P
        L = self.fft_length
        H = L // 2
        dev = sp.device

        eps = 1e-6
        ap = torch.clamp(ap, eps, 1 - eps)
        sp = torch.clamp(sp, min=eps)

        # GetTemporalParametersForTimeBase()
        f_min = self.sample_rate / L + 1
        coarse_f0 = torch.where(f0 < f_min, torch.zeros_like(f0),
                                f0).detach()
        coarse_vuv = (0 < coarse_f0).to(coarse_f0.dtype)
        # Frame rate -> sample rate on the uniform frame grid: the two lerp
        # endpoints are a P-fold repeat of the frame track and of its
        # shift by one (edge-extended).
        wt = torch.arange(P, dtype=f0.dtype, device=dev)[None, :] / P

        def upsample(c):
            c = c[..., :N]              # tolerate an over-long f0 track
            lo = c[..., :, None]                              # (B, N, 1)
            hi = torch.cat([c[..., 1:], c[..., -1:]], dim=-1)[..., :, None]
            out = lo * (1 - wt) + hi * wt                     # (B, N, P)
            return out.reshape(*c.shape[:-1], N * P)

        interp_f0 = upsample(coarse_f0)
        interp_vuv = upsample(coarse_vuv) > 0.5
        interp_f0 = torch.where(interp_vuv, interp_f0,
                                torch.full_like(interp_f0, self.default_f0))

        # GetPulseLocationsForTimeBase(): pulses fire at the wraps of the
        # fixed-point phase integral.
        wrap_phase = _wrap_phase_fixed_point(
            TAU / self.sample_rate * interp_f0)
        dphase = torch.abs(torch.diff(wrap_phase, dim=-1))  # (B, T-1)
        pulse_mask = np.pi < dphase

        # The minimum pulse spacing is sr/f0_ceil samples; it sizes the
        # slot table.
        min_period = max(int(self.sample_rate / self.f0_ceil), 1)
        max_pulses = T // min_period + 2

        # Slot s holds the s-th pulse's time index: the first t whose
        # running pulse count reaches s+1.
        csum = torch.cumsum(pulse_mask.to(torch.int32), dim=-1,
                            dtype=torch.int32)
        wanted = torch.arange(1, max_pulses + 1, dtype=torch.int32,
                              device=dev).expand(B, -1).contiguous()
        time_index = torch.searchsorted(csum, wanted, side="left")
        n_pulses = csum[:, -1]                              # (B,)
        valid = (torch.arange(max_pulses, device=dev)[None, :]
                 < n_pulses[:, None])
        # Invalid slots repeat the last valid pulse index, so the final
        # pulse's noise_size is 0, as in the reference.
        last_valid = torch.amax(
            torch.where(valid, time_index, torch.zeros_like(time_index)),
            dim=-1, keepdim=True)
        time_index = torch.where(valid, time_index, last_valid)

        # Fractional pulse-time shift: y1 = wrap[t] - TAU and y2 - y1 =
        # TAU - dphase[t] (a pulse is a wrap).
        wrap_ti = torch.gather(wrap_phase[..., :-1], 1, time_index)
        dphase_ti = torch.gather(dphase, 1, time_index)
        time_shift = ((TAU - wrap_ti) / (TAU - dphase_ti)
                      / self.sample_rate)                  # (B, Pmax)

        # GetSpectralEnvelope() / GetAperiodicRatio(): one lerped read of
        # the (sp | ap | vuv) rows at the pulse's frame coordinate.
        frame = time_index.to(f0.dtype) / P
        f_floor = torch.clamp(torch.floor(frame).long(), max=N - 1)
        f_ceil = torch.clamp(torch.ceil(frame).long(), max=N - 1)
        w_hi = (frame - f_floor)[..., None]
        w_lo = 1 - w_hi
        spap = torch.cat(
            [sp, ap, coarse_vuv[..., :N, None]], dim=-1)   # (B, N, 2D+1)
        bidx = torch.arange(B, device=dev)[:, None]
        g = w_lo * spap[bidx, f_floor] + w_hi * spap[bidx, f_ceil]
        env = g[..., :D]
        apr = g[..., D:2 * D] ** 2
        vuv = g[..., 2 * D:] > 0.5                         # (B, Pmax, 1)

        noise_size = torch.diff(time_index, dim=-1,
                                append=time_index[:, -1:])
        noise_size = torch.clamp(noise_size, min=0)[..., None].to(sp.dtype)
        response = self._slot_responses(env, apr, vuv, time_shift,
                                        noise_size, valid, time_index, T)

        # Synthesis(): the overlap-add kernel.
        margin = (L + P - 1) // P * P
        # The slot table is sorted and in range by construction: no check
        # (a host read that would stall the host mid-chain).
        y = overlap_add(time_index, response, T + margin, check=False)
        y = y[:, H:H + T]

        if one_d:
            y = y[0]
        if out_length is not None:
            y = y[..., :out_length]
        return y
