"""Time-block-sharded framed transforms (counterpart of
``diffsptk_tpu/parallel/sharded.py``).

``sharded_frame`` reproduces Frame's framing with the waveform sharded
over the mesh's time axis: a halo exchange, then a block-local gather.
``ShardedSTFT`` composes it with the frame-parallel window and spectrum
stages, so the FFT runs on dense block-local buffers.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.stft import ShortTimeFourierTransform
from .halo import exchange_halo
from .mesh import Axis


def _halos(frame_length: int, frame_period: int, center: bool):
    halo_l = frame_length // 2 if center else 0
    halo_r = max(frame_length - 1 - halo_l - (frame_period - 1), 0)
    return halo_l, halo_r


def _block_frames(x_ext: torch.Tensor, n_frames: int, frame_length: int,
                  frame_period: int) -> torch.Tensor:
    """The n_frames frames of a halo-extended block (..., L)."""
    return x_ext.unfold(-1, frame_length, frame_period)[..., :n_frames, :]


def _check_block(T_local: int, frame_period: int) -> None:
    if T_local % frame_period:
        raise ValueError("T must be divisible by frame_period * "
                         "n_time_shards")


def sharded_frame(x: torch.Tensor, frame_length: int, frame_period: int,
                  mesh: DeviceMesh, time_axis_name: str = "tp",
                  batch_axis_name: str | None = "dp",
                  center: bool = True, zmean: bool = False) -> torch.Tensor:
    """Frame this rank's block of a time-sharded waveform:
    (..., T/n_tp) -> (..., T/(P n_tp), L), the rank's block of
    ``Frame(L, P, center=center, zmean=zmean)`` of the whole waveform.
    The local block length must be a multiple of frame_period.
    ``batch_axis_name`` names the axis the leading dimension is sharded
    over (it changes nothing in the local computation)."""
    L, P = frame_length, frame_period
    _check_block(x.shape[-1], P)
    halo_l, halo_r = _halos(L, P, center)
    x_ext = exchange_halo(x, halo_l, halo_r, Axis(mesh, time_axis_name))
    y = _block_frames(x_ext, x.shape[-1] // P, L, P)
    if zmean:
        y = y - torch.mean(y, dim=-1, keepdim=True)
    return y


class ShardedSTFT:
    """STFT over a (dp, tp) mesh: batch over dp, frames over tp.

    Takes this rank's block (..., T/n_tp) and returns its frames
    (..., T/(P n_tp), fft_length/2 + 1), equal to the rank's block of
    ``ShortTimeFourierTransform`` of the whole waveform.  The window and
    the spectrum run on the local frames.  The operator is built as the
    port builds every operator (on the card unless ``device="cpu"``)."""

    def __init__(self, mesh: DeviceMesh, frame_length: int,
                 frame_period: int, fft_length: int, *,
                 time_axis_name: str = "tp",
                 batch_axis_name: str | None = "dp", **stft_kwargs) -> None:
        self.mesh = mesh
        self.time_axis_name = time_axis_name
        self.batch_axis_name = batch_axis_name
        self.frame_length = frame_length
        self.frame_period = frame_period
        self.op = ShortTimeFourierTransform(
            frame_length, frame_period, fft_length, **stft_kwargs)
        if self.op.frame.mode != "constant":
            raise ValueError("sharded STFT supports constant padding only")

    def __call__(self, x: torch.Tensor,
                 window_params: dict | None = None) -> torch.Tensor:
        """Apply; ``window_params`` optionally overrides the window
        module's tensors by name (``{"window": w}``), through
        ``torch.func.functional_call``, for training a learnable window."""
        L, P = self.frame_length, self.frame_period
        _check_block(x.shape[-1], P)
        halo_l, halo_r = _halos(L, P, self.op.frame.center)
        x_ext = exchange_halo(x, halo_l, halo_r,
                              Axis(self.mesh, self.time_axis_name))
        y = _block_frames(x_ext, x.shape[-1] // P, L, P)
        if self.op.frame.zmean:
            y = y - torch.mean(y, dim=-1, keepdim=True)
        if window_params is None:
            y = self.op.window(y)
        else:
            y = torch.func.functional_call(self.op.window, window_params,
                                           (y,))
        return self.op.spec(y)
