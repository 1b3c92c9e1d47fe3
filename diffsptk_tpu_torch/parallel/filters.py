"""Sequence-parallel recurrent filters (counterpart of
``diffsptk_tpu/parallel/filters.py``).

The time-varying all-pole recurrence (ops/poledf.py) is causal with an
order-M state, so a time-sharded input cannot be filtered block-locally.
The blocked decomposition of kernels/recurrence.py summarises each block
as an affine state map s_out = c + C s_in; across ranks the same
summaries are all-gathered (M + M^2 numbers a row and rank) and folded,
which gives every rank its exact entering state: no warmup
approximation, and the output equals the one-rank blocked form up to
the order of float sums.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import full_precision
from ..kernels.recurrence import sample_wise_lpc
from .halo import exchange_halo
from .mesh import Axis


class ShardedAllPoleDigitalFilter:
    """(excitation (B, T), LPC (B, T/P, M+1)) -> waveform (B, T) with the
    batch over ``dp`` and the time over ``tp``: each rank passes its
    blocks (B/n_dp, T/n_tp) and (B/n_dp, T/(P n_tp), M+1) and receives
    its block of the waveform."""

    def __init__(self, mesh: DeviceMesh, filter_order: int,
                 frame_period: int, *, ignore_gain: bool = False,
                 block: int = 256, time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp") -> None:
        if filter_order < 0:
            raise ValueError("filter_order must be non-negative.")
        if frame_period <= 0:
            raise ValueError("frame_period must be positive.")
        self.mesh = mesh
        self.tp = time_axis_name
        self.dp = batch_axis_name
        self.frame_period = frame_period
        self.ignore_gain = ignore_gain
        self.block = block

    @full_precision
    def __call__(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        P = self.frame_period
        T_l = x.shape[-1]
        if T_l % P:
            raise ValueError(
                "T must be divisible by frame_period * n_time_shards.")
        tp = Axis(self.mesh, self.tp)
        # frame -> sample interpolation: the upper bracket of the last
        # local frame is the neighbour's first (the edge fill replicates
        # the final frame at the global end, as the unsharded op does)
        a_ext = exchange_halo(a, 0, 1, tp, axis=-2, pad_mode="edge")
        w = (torch.arange(P, dtype=a.dtype, device=a.device) / P)[:, None]
        a_s = (a_ext[..., :-1, None, :] * (1 - w)
               + a_ext[..., 1:, None, :] * w)
        a_s = a_s.reshape(*a.shape[:-2], T_l, a.shape[-1])
        K, a1 = a_s[..., 0], a_s[..., 1:]
        if not self.ignore_gain:
            x = K * x
        # the cross-rank summary needs block | T_l: the largest divisor
        # of T_l not above the requested block
        block = self.block
        while T_l % block:
            block -= 1
        return sample_wise_lpc(x, a1, block=block, axis_name=tp)
