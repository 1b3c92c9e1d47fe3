"""Overlap-add: hand-written CUDA kernel, plain twin and autograd Function
(counterpart of ``diffsptk_tpu/kernels/pallas_ola.py``).

y[b, tidx[b, p] : tidx[b, p] + L] += resp[b, p] for every slot p.  On a
CUDA float32 tensor the sum is ``csrc/ola.cu``, output-stationary and so
deterministic, in two passes: each group of GROUP consecutive slots is
overlap-added into its own region of a workspace row, then each output sums
the regions that cover it (:func:`overlap_add_grouped` is the same
computation in torch, in the same order).  Elsewhere (a CPU tensor,
float64, or inside ``twins()``) it is :func:`overlap_add_plain`, an
``index_add`` as the JAX package's fallback is a scatter-add.  The entry
takes start indices that satisfy 0 <= tidx <= out_len - L and are
nondecreasing along each row (WORLD's slot table guarantees both,
ops/world_synth.py) and, unless told not to, checks them.

The backward is the adjoint, a windowed gather of the output gradient at
the same starts: on the card it runs the gather kernel (kernels/gather.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .state import use_twins

GROUP = 64
"""Slots a group in the kernel's first pass: where L is at least the
kernel's 256-value tile, a thread's serial chain is at most 2 GROUP slots.
64 measured fastest of 32, 64, 128 and 256 at the [world] shapes
(tools/torch_ola_ab.py)."""

launches = 0
"""Number of kernel calls so far, one per overlap-add (each enqueues the
kernel's two passes; the twin does not count)."""


def overlap_add_plain(tidx: torch.Tensor, resp: torch.Tensor,
                      out_len: int) -> torch.Tensor:
    """Plain twin: tidx (B, P) integer, resp (B, P, L) -> (B, out_len)."""
    B, P, L = resp.shape
    idx = tidx[..., None].long() + torch.arange(L, device=resp.device)
    idx = idx + out_len * torch.arange(B, device=resp.device)[:, None, None]
    out = torch.zeros(B * out_len, dtype=resp.dtype, device=resp.device)
    return out.index_add(0, idx.reshape(-1),
                         resp.reshape(-1)).reshape(B, out_len)


def overlap_add_grouped(tidx: torch.Tensor, resp: torch.Tensor,
                        out_len: int, perm: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The kernel's computation, in its order, in torch: group g (slots
    g GROUP .. g GROUP + GROUP - 1) is overlap-added slot by slot into the
    workspace at t + g L, then each output t sums, in ascending g, the
    groups whose span [first(g), last(g) + L) covers it.  Equal to the
    kernel bit for bit; a slot-by-slot loop, for tests."""
    B, P, L = resp.shape
    G = -(-P // GROUP)
    ws = torch.zeros((B, out_len + G * L), dtype=resp.dtype,
                     device=resp.device)
    rows = torch.arange(B, device=resp.device)[:, None]
    k = torch.arange(L, device=resp.device)
    tidx = tidx.long()
    for p in range(P):
        r = resp[:, p] if perm is None else resp[rows[:, 0], perm[:, p]]
        idx = tidx[:, p, None] + (p // GROUP) * L + k
        ws[rows, idx] = ws[rows, idx] + r
    y = torch.zeros((B, out_len), dtype=resp.dtype, device=resp.device)
    t = torch.arange(out_len, device=resp.device)
    for g in range(G):
        first = tidx[:, g * GROUP, None]
        end = tidx[:, min(g * GROUP + GROUP, P) - 1, None] + L
        cover = (t >= first) & (t < end)
        y = torch.where(cover, y + ws[:, g * L:g * L + out_len], y)
    return y


@functools.cache
def _lib():
    fn = build.library("ola").overlap_add_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def overlap_add_cuda(tidx: torch.Tensor, resp: torch.Tensor, out_len: int,
                     perm: torch.Tensor | None = None) -> torch.Tensor:
    """The overlap-add on the card.  tidx (B, P) sorted along each row,
    in [0, out_len - L]; resp (B, P, L) float32; ``perm`` (B, P), when
    given, names the response row of each sorted slot.  The caller
    guarantees the order and range; this raises on types and shapes.
    Integer tidx and perm are taken as int64 (the callers' type: no
    conversion)."""
    global launches
    if not (tidx.is_cuda and resp.is_cuda):
        raise ValueError("overlap_add_cuda takes CUDA tensors")
    if resp.dtype != torch.float32:
        raise TypeError(
            f"the overlap-add kernel takes float32, not {resp.dtype}")
    B, P, L = resp.shape
    if tidx.shape != (B, P) or (perm is not None and perm.shape != (B, P)):
        raise ValueError(
            f"tidx must be (B, P) for resp (B, P, L); got "
            f"{tuple(tidx.shape)} and {tuple(resp.shape)}")
    if out_len < L:
        raise ValueError("out_len must be at least the window length")
    resp = resp.contiguous()
    tidx = tidx.to(torch.int64).contiguous()
    if perm is not None:
        perm = perm.to(torch.int64).contiguous()
    y = torch.empty((B, out_len), dtype=resp.dtype, device=resp.device)
    if P == 0:
        return y.zero_()
    G = -(-P // GROUP)
    ws = torch.empty((B, out_len + G * L), dtype=resp.dtype,
                     device=resp.device)
    stream = torch.cuda.current_stream(resp.device).cuda_stream
    with torch.cuda.device(resp.device):
        err = _lib()(tidx.data_ptr(),
                     None if perm is None else perm.data_ptr(),
                     resp.data_ptr(), ws.data_ptr(), y.data_ptr(), B, P, L,
                     out_len, GROUP, stream)
    build.check(err, "overlap_add_f32")
    launches += 1
    return y


def _check_shapes(tidx: torch.Tensor, resp: torch.Tensor) -> None:
    if resp.ndim != 3 or tidx.shape != resp.shape[:2]:
        raise ValueError(
            f"tidx must be (B, P) and resp (B, P, L); got "
            f"{tuple(tidx.shape)} and {tuple(resp.shape)}")
    if tidx.is_floating_point() or tidx.is_complex():
        raise TypeError("tidx must be integer")


def _validate(tidx: torch.Tensor, resp: torch.Tensor, out_len: int) -> None:
    """The starts' range and order: one host read for all three
    conditions."""
    L = resp.shape[-1]
    if tidx.numel() == 0:
        return
    step = (torch.diff(tidx, dim=-1).min() if tidx.shape[-1] > 1
            else torch.zeros((), dtype=tidx.dtype, device=tidx.device))
    lo, hi, dmin = torch.stack([tidx.min(), tidx.max(), step]).tolist()
    if lo < 0 or hi > out_len - L:
        raise ValueError(
            f"start indices must lie in [0, out_len - L] = [0, "
            f"{out_len - L}]; got [{lo}, {hi}]")
    if dmin < 0:
        raise ValueError("start indices must be nondecreasing along a row")


def _use_kernel(resp: torch.Tensor) -> bool:
    return (resp.is_cuda and resp.dtype == torch.float32
            and not use_twins())


class OverlapAdd(torch.autograd.Function):
    """Forward: the kernel on CUDA float32, the twin elsewhere.
    Backward: the gather of the output gradient (kernel on CUDA
    float32)."""

    @staticmethod
    def forward(ctx, tidx, resp, out_len):
        ctx.save_for_backward(tidx)
        ctx.L = resp.shape[-1]
        if _use_kernel(resp):
            return overlap_add_cuda(tidx, resp, out_len)
        return overlap_add_plain(tidx, resp, out_len)

    @staticmethod
    def backward(ctx, g):
        from . import gather

        (tidx,) = ctx.saved_tensors
        g = g.contiguous()
        if _use_kernel(g):
            return None, gather.gather_windows_cuda(g, tidx, ctx.L), None
        return None, gather.gather_windows_plain(g, tidx, ctx.L), None


def overlap_add(tidx: torch.Tensor, resp: torch.Tensor, out_len: int, *,
                check: bool = True) -> torch.Tensor:
    """y[b, tidx[b,p] : tidx[b,p]+L] += resp[b, p] for every slot p.

    tidx (B, P) integer, nondecreasing along each row, in
    [0, out_len - L]; resp (B, P, L) -> y (B, out_len).  Raises where the
    starts break either condition; ``check=False`` skips that check and
    its host read, for a caller whose slot table guarantees both by
    construction (WORLD's synthesis).  Differentiable in resp.
    """
    _check_shapes(tidx, resp)
    if check:
        _validate(tidx, resp, out_len)
    return OverlapAdd.apply(tidx, resp, out_len)
