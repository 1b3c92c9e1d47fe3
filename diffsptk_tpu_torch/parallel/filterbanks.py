"""The time-sharded filterbank battery (BASELINE.json configs[4]):
PQMF / IPQMF, MDCT / IMDCT and CQT / ICQT over a (dp, tp) mesh
(counterpart of ``diffsptk_tpu/parallel/filterbanks.py``).

All six equal the one-rank ops (up to the frame-count conventions
below).  Three patterns:

* PQMF / IPQMF are fixed FIR banks: overlap-save with a (delay_l,
  delay_r) sample halo, zero at the global left edge and edge-replicated
  at the right, the one-rank delay padding (ops/pqmf.py:_pad_signal).
* MDCT / IMDCT are 50 %-overlap framed transforms (P = L/2): the analysis
  needs a one-period left halo; the synthesis overlap-adds the right
  neighbour's first frame row.  The trailing perfect-reconstruction frame,
  which reads only the global tail, lives on the last time rank.
* CQT / ICQT run the whole multi-rate octave chain block-locally over a
  static halo (overlap-save at the base rate): every stage is a
  finite-support linear map, so a halo that covers the receptive field
  and the resamplers' margins makes the owned frames or samples exact.
  The ICQT overlap-adds each octave's frames with one
  ``conv_transpose1d`` (ROADMAP C.6) and normalises by the frames that
  are globally valid.

Under a profiler each call is the span ``Sharded<name>``, the CQT's and
the ICQT's the stages ``ShardedCQT`` and ``ShardedICQT``
(``utils/profiling.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..core import full_precision
from ..ops.cqt import ConstantQTransform, InverseConstantQTransform
from ..ops.mdct import (
    InverseModifiedDiscreteCosineTransform,
    ModifiedDiscreteCosineTransform,
)
from ..ops.pqmf import (
    PseudoQuadratureMirrorFilterBankAnalysis,
    PseudoQuadratureMirrorFilterBankSynthesis,
)
from ..utils.profiling import span, stage
from ..utils.resample import Resampler
from .halo import exchange_halo
from .mesh import Axis


class _ShardedFIRBank:
    """The PQMF pair's machinery: a halo'd grouped FIR."""

    def __init__(self, mesh: DeviceMesh, op, time_axis_name: str,
                 batch_axis_name: str | None) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.op = op

    @full_precision
    def _run(self, x: torch.Tensor) -> torch.Tensor:
        dl, dr = self.op.delay
        ext = exchange_halo(x, dl, dr, Axis(self.mesh, self.tp),
                            pad_mode=("constant", "edge"))
        return F.conv1d(ext, self.op.filters)


class ShardedPQMF(_ShardedFIRBank):
    """PQMF analysis over a (dp, tp) mesh: the local block (B_l, T_l) ->
    (B_l, K, T_l), equal to the rank's block of
    PseudoQuadratureMirrorFilterBankAnalysis of the whole signal."""

    def __init__(self, mesh: DeviceMesh, n_band: int, filter_order: int, *,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        super().__init__(mesh, PseudoQuadratureMirrorFilterBankAnalysis(
            n_band, filter_order, **kwargs), time_axis_name, batch_axis_name)

    @span("ShardedPQMF")
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x[:, None, :] if x.ndim == 2 else x)


class ShardedIPQMF(_ShardedFIRBank):
    """PQMF synthesis over a (dp, tp) mesh: (B_l, K, T_l) -> (B_l, 1, T_l)."""

    def __init__(self, mesh: DeviceMesh, n_band: int, filter_order: int, *,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        super().__init__(mesh, PseudoQuadratureMirrorFilterBankSynthesis(
            n_band, filter_order, **kwargs), time_axis_name, batch_axis_name)

    @span("ShardedIPQMF")
    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        return self._run(y)


class ShardedMDCT:
    """MDCT over a (dp, tp) mesh: the local block (B_l, T_l) -> its body
    frames (B_l, T_l/P, L/2), P = L/2; the last time rank also holds the
    trailing perfect-reconstruction frame (B_l, T_l/P + 1, L/2).  ``unshard``
    of the blocks (time_dim=-2) equals ModifiedDiscreteCosineTransform of
    the whole signal, (B, T/P + 1, L/2).  T_l must be a multiple of P."""

    def __init__(self, mesh: DeviceMesh, frame_length: int, *,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.op = ModifiedDiscreteCosineTransform(frame_length, **kwargs)
        self.frame_length = frame_length

    @full_precision
    @span("ShardedMDCT")
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        P = self.frame_length // 2
        if x.shape[-1] % P:
            raise ValueError(
                "T must be divisible by (frame_length // 2) * n_time_shards")
        n_b = x.shape[-1] // P
        tp = Axis(self.mesh, self.tp)
        window, mdt = self.op.window, self.op.mdt
        ext = exchange_halo(x, P, 0, tp)                   # (B, T_l + P)
        v = ext.reshape(*ext.shape[:-1], n_b + 1, P)
        frames = mdt(window(torch.cat([v[..., :-1, :], v[..., 1:, :]], -1)))
        if not tp.last:
            return frames
        # the trailing frame: [T - P, T + P) of the zero-extended signal
        tail = F.pad(x[..., -P:], (0, P))[..., None, :]
        return torch.cat([frames, mdt(window(tail))], dim=-2)


class ShardedIMDCT:
    """IMDCT over a (dp, tp) mesh: the local frames (B_l, N_l, L/2), the
    last time rank's with the trailing frame as its last row (the layout
    ShardedMDCT returns) -> the local block (B_l, N_l P).  Each rank
    overlap-adds its right neighbour's first frame row (the trailing frame
    on the last rank).  ``unshard`` of the blocks equals
    InverseModifiedDiscreteCosineTransform with out_length=None."""

    def __init__(self, mesh: DeviceMesh, frame_length: int, *,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.op = InverseModifiedDiscreteCosineTransform(frame_length,
                                                         **kwargs)
        self.frame_length = frame_length

    @full_precision
    @span("ShardedIMDCT")
    def __call__(self, y: torch.Tensor,
                 out_length: int | None = None) -> torch.Tensor:
        """``out_length`` cuts the global signal: each rank keeps its part
        of the first out_length samples."""
        P = self.frame_length // 2
        tp = Axis(self.mesh, self.tp)
        imdt, window = self.op.imdt, self.op.window
        body = y[..., :-1, :] if tp.last else y
        nloc = body.shape[-2]
        w = self.op.unframe.window.to(torch.float64)
        den = (w[P:] ** 2 + w[:P] ** 2).to(y.dtype)        # TDAC constant
        u = window(imdt(body))                            # (B, nloc, L)
        ext = exchange_halo(u, 0, 1, tp, axis=-2)
        if tp.last:
            # the last rank's right "halo" is the trailing frame
            rows = torch.cat([ext[..., :-1, :],
                              window(imdt(y[..., -1:, :]))], dim=-2)
        else:
            rows = ext
        num = rows[..., :-1, P:] + rows[..., 1:, :P]       # (B, nloc, P)
        x = (num / (den + 1e-16)).reshape(*num.shape[:-2], nloc * P)
        if out_length is not None:
            start = tp.index * nloc * P
            x = x[..., :max(0, min(nloc * P, out_length - start))]
        return x


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class ShardedCQT:
    """CQT over a (dp, tp) mesh: the local block (B_l, T_l) -> its frames
    (B_l, T_l/fp, K) complex.

    Overlap-save at the base rate: each rank runs the whole one-rank
    octave chain on its halo-extended block and keeps its own frames.  It
    emits the T/fp whole-period frames (the one-rank op's trailing
    centre-padded frame is not computed): ``unshard`` of the blocks
    equals ConstantQTransform(x)[..., :T // fp, :].  T_l must be a
    multiple of lcm(frame_period, total decimation), and with more than
    one time rank at least the halo (``self.halo``: 295,168 samples for
    CQT(64, 16000, n_bin=24))."""

    def __init__(self, mesh: DeviceMesh, frame_period: int,
                 sample_rate: int, *, time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.fp = frame_period
        self.op = ConstantQTransform(frame_period, sample_rate, **kwargs)

        ed = self.op.early_downsample
        n_halve = sum(isinstance(h, Resampler) for h in self.op.halves)
        self.dec_total = (ed.orig_freq if ed is not None else 1) << n_halve
        fft_len = self.op.transforms[0].frame.frame_length
        widths = [h.width for h in self.op.halves
                  if isinstance(h, Resampler)]
        if ed is not None:
            widths.append(ed.width)
        wmax = max(widths, default=0)
        # the receptive field of one frame at the deepest octave plus the
        # resamplers' accumulated margins, in base-rate samples
        self.align = _lcm(frame_period, self.dec_total)
        h0 = self.dec_total * (fft_len + 8 * (wmax + 8))
        self.halo = -(-h0 // self.align) * self.align

    @full_precision
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with stage("ShardedCQT", x.device):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = Axis(self.mesh, self.tp)
        T_l = x.shape[-1]
        if T_l % self.align:
            raise ValueError(
                f"T must be divisible by {self.align * tp.size} "
                "(lcm(frame_period, decimation) * n_time_shards)")
        T = T_l * tp.size
        n_b = T_l // self.fp
        H = self.halo
        j0 = H // self.fp
        op = self.op
        # the one-rank forward with one addition: after every rate change
        # the local segment is cut to the *global* signal's extent, as
        # the one-rank op's decimated signals end at the global edges
        g0 = tp.index * T_l - H          # global base index of xx[0]

        def mask(v, dec, glen):
            gi = g0 // dec + torch.arange(v.shape[-1], device=v.device)
            return v * ((0 <= gi) & (gi < glen)).to(v.dtype)

        xx = exchange_halo(x, H, H, tp)
        dec, glen = 1, T
        if op.early_downsample is not None:
            F_ = op.early_downsample.orig_freq
            xx = op.early_downsample(xx) * op.downsample_scale
            glen = -(-glen // F_)
            dec *= F_
            xx = mask(xx, dec, glen)
        cs = []
        for i, stft in enumerate(op.transforms):
            cs.append(torch.matmul(stft(xx), getattr(op, f"fft_basis_{i}")))
            if i < len(op.halves) and isinstance(op.halves[i], Resampler):
                xx = op.halves[i](xx) * op.halve_scales[i]
                glen = -(-glen // 2)
                dec *= 2
                xx = mask(xx, dec, glen)
        c = op._trim_stack(op.cqt_scale.shape[0], cs) * op.cqt_scale
        return c[..., j0:j0 + n_b, :]


class ShardedICQT:
    """ICQT over a (dp, tp) mesh: the local frames (B_l, N_l, K) complex
    -> the local block (B_l, N_l fp).

    Per octave the rank rebuilds its octave-rate segment from a frame
    halo (one ``conv_transpose1d``; the overlap-add's normaliser counts
    the globally valid frames, so the global edges are the one-rank op's),
    upsamples it and keeps its own base-rate samples.  ``unshard`` of the
    blocks equals InverseConstantQTransform(c, out_length=N fp)."""

    def __init__(self, mesh: DeviceMesh, frame_period: int,
                 sample_rate: int, *, time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **kwargs) -> None:
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.fp = frame_period
        self.op = InverseConstantQTransform(frame_period, sample_rate,
                                            **kwargs)
        self.n_oct = len(self.op.slices)
        self.fp_i = list(self.op.hops)
        self.L = self.op.time_basis_0.shape[-1]
        self.dec = [self.fp // f for f in self.fp_i]
        for f in self.fp_i:
            if self.L % f:
                raise ValueError(
                    "sharded ICQT requires frame_period_i | fft_length")
        self.mm = [r.width + 8 * d
                   for r, d in zip(self.op.resamplers, self.dec)]
        self.Hf = -(-(self.L + 2 * max(self.mm)) // min(self.fp_i)) + 2

    @full_precision
    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        with stage("ShardedICQT", c.device):
            return self._forward(c)

    def _forward(self, c: torch.Tensor) -> torch.Tensor:
        tp = Axis(self.mesh, self.tp)
        n_b = c.shape[-2]
        N = n_b * tp.size
        Hf, L, op = self.Hf, self.L, self.op
        if tp.size > 1 and Hf > n_b:
            raise ValueError(
                f"frame halo {Hf} exceeds the local block {n_b}")
        T_l = n_b * self.fp
        g0 = tp.index * n_b - Hf             # global index of ext row 0
        ext = exchange_halo(c, Hf, Hf, tp, axis=-2)
        n_ext = n_b + 2 * Hf
        dev = c.device
        y = None
        for i, sl in enumerate(op.slices):
            hop = self.fp_i[i]
            C = ext[..., sl]
            a = torch.cat([C.real, C.imag], dim=-1)        # (B, n_ext, 2K)
            basis = getattr(op, f"time_basis_{i}")        # (2K, L)
            # the frames' overlap-add over the extended rows (zeros beyond
            # the global edges), normalised by the globally valid frames
            # that cover each sample (a rectangular window)
            num = F.conv_transpose1d(
                a.reshape(-1, n_ext, a.shape[-1]).transpose(1, 2),
                basis[:, None, :], stride=hop)[:, 0]
            num = num.reshape(*a.shape[:-2], num.shape[-1])
            t = torch.arange(num.shape[-1], device=dev)
            last = torch.clamp(torch.div(t, hop, rounding_mode="floor"),
                               max=min(n_ext, N - g0) - 1)
            first = torch.clamp(
                -torch.div(L - 1 - t, hop, rounding_mode="floor"),
                min=max(0, -g0))
            den = torch.clamp(last - first + 1, min=0).to(num.dtype)
            xi = num / (den + 1e-16)
            # the owned octave segment with its margin, cut to the global
            # octave signal's extent, upsampled; keep the owned samples
            mm = self.mm[i]
            q0 = Hf * hop + L // 2 - mm
            seg_len = T_l // self.dec[i] + 2 * mm
            seg = xi[..., q0:q0 + seg_len]
            m = (tp.index * (T_l // self.dec[i]) - mm
                 + torch.arange(seg_len, device=dev))
            seg = seg * ((0 <= m) & (m < N * hop)).to(seg.dtype)
            up = op.resamplers[i](seg)
            own = up[..., mm * self.dec[i]:mm * self.dec[i] + T_l]
            y = own if y is None else y + own
        return y
