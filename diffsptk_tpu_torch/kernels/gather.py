"""Windowed gather: hand-written CUDA kernel, plain twin and autograd
Function (counterpart of ``diffsptk_tpu/kernels/pallas_gather.py``).

out[b, n, k] = x[b, clamp(starts[b, n] + k, 0, T-1)] for k < length.  On a
CUDA float32 tensor the gather is ``csrc/gather.cu``; elsewhere (a CPU
tensor, float64, or inside ``twins()``) it is :func:`gather_windows_plain`,
the JAX package's fallback rule.  Indices are clamped elementwise on both
paths, so they agree on every input.

The kernel walks the output as one flat span: :func:`gather_windows_walk`
repeats its index walk in torch, and :func:`split_index` its division by
a reciprocal computed here on the host.

The backward is the adjoint, an overlap-add of the output gradient at the
same starts: on the card it runs the overlap-add kernel
(``kernels/ola.py``), so WORLD's gradients stay in the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import span
from . import build
from .state import use_twins

launches = 0
"""Number of kernel launches so far (the twin does not count)."""

PER_LANE = 8                 # values a thread (csrc/gather.cu kPerLane)
SPAN = 32 * PER_LANE         # consecutive values of a warp (kSpan)


def gather_windows_plain(x: torch.Tensor, starts: torch.Tensor,
                         length: int) -> torch.Tensor:
    """Plain twin: x (B, T), starts (B, N) integer -> (B, N, length)."""
    T = x.shape[-1]
    k = torch.arange(length, device=x.device)
    idx = (starts[..., None].long() + k).clamp(0, T - 1)
    return torch.gather(x[:, None, :].expand(-1, idx.shape[1], -1), 2, idx)


def split_index(a: torch.Tensor, d: int, inv: float):
    """(a // d, a % d) for 0 <= a < 2**53 as the kernel computes them: the
    float64 product of a with ``inv = 1.0 / d`` truncated, then corrected
    by one step."""
    q = (a.to(torch.float64) * inv).long()
    r = a - q * d
    low, high = r < 0, r >= d
    q = q - low.long() + high.long()
    r = r + d * low.long() - d * high.long()
    return q, r


def gather_windows_walk(x: torch.Tensor, starts: torch.Tensor,
                        length: int) -> torch.Tensor:
    """The kernel's index walk in torch, every lane at once: lane l of
    warp u takes the flat outputs u * SPAN + l + 32 j, j < PER_LANE, finds
    the window and row of the first by :func:`split_index` and steps 32
    values a time across window and row edges, reading each window's
    start as the kernel does.  Equal to :func:`gather_windows_plain`."""
    B, T = x.shape
    N = starts.shape[1]
    windows = B * N
    total = windows * length
    flat_starts = starts.reshape(-1).long()
    flat_x = x.reshape(-1)
    out = torch.empty(total, dtype=x.dtype, device=x.device)
    u = torch.arange(-(-total // SPAN), device=x.device)
    f = (u[:, None] * SPAN + torch.arange(32, device=x.device)).reshape(-1)
    f = f[f < total]                       # lanes past the end return

    def start_of(w):
        return torch.where(w < windows,
                           flat_starts[w.clamp(max=windows - 1)], 0)

    w, k = split_index(f, length, 1.0 / length)
    b, n = split_index(w, N, 1.0 / N)
    s, s_next = start_of(w), start_of(w + 1)
    for j in range(PER_LANE):
        fj = f + 32 * j
        live = fj < total
        i = (s + k).clamp(0, T - 1)
        out[fj[live]] = flat_x[(b * T + i)[live]]
        k = k + 32
        while True:
            cross = k >= length
            if not bool(cross.any()):
                break
            k = torch.where(cross, k - length, k)
            w = w + cross.long()
            n = n + cross.long()
            row = cross & (n == N)
            n = torch.where(row, 0, n)
            b = b + row.long()
            s = torch.where(cross, s_next, s)
            s_next = torch.where(cross, start_of(w + 1), s_next)
    return out.reshape(B, N, length)


@functools.cache
def _lib():
    fn = build.library("gather").gather_windows_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_double] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, starts: torch.Tensor, length: int) -> None:
    if x.ndim != 2 or starts.ndim != 2 or starts.shape[0] != x.shape[0]:
        raise ValueError(
            f"x must be (B, T) and starts (B, N); got {tuple(x.shape)} and "
            f"{tuple(starts.shape)}")
    if length < 1:
        raise ValueError("length must be positive")
    if starts.is_floating_point() or starts.is_complex():
        raise TypeError("starts must be integer")


@span("kernel.gather")
def gather_windows_cuda(x: torch.Tensor, starts: torch.Tensor,
                        length: int) -> torch.Tensor:
    """The gather on the card: x (B, T) float32, starts (B, N) integer.
    Raises on what the kernel does not take."""
    global launches
    _check(x, starts, length)
    if not (x.is_cuda and starts.is_cuda):
        raise ValueError("gather_windows_cuda takes CUDA tensors")
    if x.dtype != torch.float32:
        raise TypeError(f"the gather kernel takes float32, not {x.dtype}")
    B, T = x.shape
    N = starts.shape[1]
    x = x.contiguous()
    starts = starts.to(torch.int64).contiguous()
    out = torch.empty((B, N, length), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), starts.data_ptr(), out.data_ptr(), B, T, N,
                     length, 1.0 / length, 1.0 / N, stream)
    build.check(err, "gather_windows_f32")
    launches += 1
    return out


def _use_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda and x.dtype == torch.float32 and not use_twins()


def scatter_windows(g: torch.Tensor, starts: torch.Tensor,
                    T: int) -> torch.Tensor:
    """Adjoint of the gather: (B, N, length) windows added into (B, T) at
    the clamped indices of ``starts``.  On the card (float32) it is the
    overlap-add kernel on a row padded by ``length`` on each side, whose
    overhangs fold onto the first and last samples; elsewhere an
    ``index_add`` twin."""
    from . import ola

    B, N, L = g.shape
    if not _use_kernel(g):
        k = torch.arange(L, device=g.device)
        idx = (starts[..., None].long() + k).clamp(0, T - 1)
        idx = idx + T * torch.arange(B, device=g.device)[:, None, None]
        out = torch.zeros(B * T, dtype=g.dtype, device=g.device)
        return out.index_add(0, idx.reshape(-1), g.reshape(-1)).reshape(B, T)
    s = starts.long().clamp(-L, T) + L
    order = torch.argsort(s, dim=-1, stable=True)
    s_sorted = torch.gather(s, 1, order)
    y = ola.overlap_add_cuda(s_sorted, g, T + 2 * L, perm=order)
    out = y[:, L:L + T].clone()
    out[:, 0] += y[:, :L].sum(-1)
    out[:, -1] += y[:, L + T:].sum(-1)
    return out


class GatherWindows(torch.autograd.Function):
    """Forward: the kernel on CUDA float32, the twin elsewhere.
    Backward: the adjoint overlap-add (kernel on CUDA float32)."""

    @staticmethod
    def forward(ctx, x, starts, length):
        ctx.save_for_backward(starts)
        ctx.T = x.shape[-1]
        if _use_kernel(x):
            return gather_windows_cuda(x, starts, length)
        return gather_windows_plain(x, starts, length)

    @staticmethod
    def backward(ctx, g):
        (starts,) = ctx.saved_tensors
        return scatter_windows(g.contiguous(), starts, ctx.T), None, None


def gather_windows(x: torch.Tensor, starts: torch.Tensor,
                   length: int) -> torch.Tensor:
    """out[b, n, k] = x[b, clamp(starts[b, n] + k, 0, T-1)], k < length.

    x (B, T) float, starts (B, N) integer -> (B, N, length).
    Differentiable in x.
    """
    _check(x, starts, length)
    return GatherWindows.apply(x, starts, length)
