"""Taylor MLSA cascade: hand-written CUDA kernel and autograd Function
(counterpart of ``diffsptk_tpu/kernels/pallas_mlsa.py``).

On a CUDA float32 tensor the S stages run as S launches of the direct
fp32 FIR of ``csrc/mlsa_cascade.cu``, enqueued by one call, the (B, N, P)
state in two ping-pong buffers: through its entry for the tap-chunked
geometry (the B2 row) where the folded form takes the chunked branch,
through its other entry otherwise (B3); both run the same kernel.  On a
CPU tensor the cascade is its plain twin,
``mlsa_cascade.taylor_cascade_folded``.

``precision`` keeps the JAX signature.  Every value runs the fp32 kernel,
which is at least the accuracy class (HIGH) that inverse-then-forward
round trips need.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .mlsa_cascade import chunked_geometry, taylor_cascade_folded
from .state import use_twins

PRECISIONS = ("DEFAULT", "HIGH", "HIGHEST")

launches = 0
"""Launches of the cascade kernel through the tap-chunked entry so far,
one per stage (the twin does not count)."""

launches_unchunked = 0
"""Launches through the unchunked entry so far, one per stage."""


@functools.cache
def _entry(name: str, defines=()):
    fn = getattr(build.library("mlsa_cascade", defines), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def tile(P: int, M: int):
    """The kernel's tile at frame period P and filter order M: (frames
    per block, threads per block, shared memory bytes), or None where one
    frame does not fit in a block's shared memory."""
    fn = build.library("mlsa_cascade").mlsa_cascade_tile
    frames, threads = ctypes.c_int(0), ctypes.c_int(0)
    nbytes = fn(P, M, ctypes.byref(frames), ctypes.byref(threads))
    return None if nbytes < 0 else (frames.value, threads.value, nbytes)


def _run(entry: str, x, c, weights, a, P: int, advance: int, defines=()):
    """Check the arguments and enqueue the S stages through ``entry``;
    returns (y, S)."""
    if not (x.is_cuda and c.is_cuda):
        raise ValueError("the cascade kernel takes CUDA tensors")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("the cascade kernel takes float32")
    B, N, P_ = x.shape
    M = c.shape[-1] - 1
    if P_ != P or c.shape[:2] != (B, N):
        raise ValueError(
            f"x must be (B, N, P) and c (B, N, M+1); got {tuple(x.shape)} "
            f"and {tuple(c.shape)}")
    if weights.shape != a.shape or weights.ndim != 1:
        raise ValueError("weights and a must both be (S+1,)")
    S = weights.shape[0] - 1
    w, a = (t.to(device=x.device, dtype=torch.float32).contiguous()
            for t in (weights, a))
    if S == 0:
        return a[0] * x, 0
    with torch.cuda.device(x.device):
        if tile(P, M) is None:
            raise ValueError(
                f"the cascade kernel cannot hold one frame of P={P}, M={M} "
                "in a block's shared memory")
        x, c = x.contiguous(), c.contiguous()
        # the kernel reads x, and c where rows allow, 16 bytes at a time
        x, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, c))
        buf = x.new_empty((2,) + x.shape)       # the stages' ping-pong
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(entry, tuple(defines))(
            x.data_ptr(), c.data_ptr(), w.data_ptr(), a.data_ptr(),
            buf.data_ptr(), y.data_ptr(), B, N, P, M, advance, S, stream)
    build.check(err, "mlsa_cascade stage")
    return y, S


def cascade_chunked_cuda(x: torch.Tensor, c: torch.Tensor,
                         weights: torch.Tensor, a: torch.Tensor, P: int,
                         advance: int, nfft_c: int,
                         _defines=()) -> torch.Tensor:
    """The cascade on the card at the tap-chunked geometry (the B2 row).

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P).  nfft_c,
    the folded form's chunk transform length, is only checked: the kernel
    needs no transform.  Raises on what the kernel does not take.
    ``_defines`` builds the kernel with those macros set: the variants of
    tools/torch_cascade_ablation.py (the one without its tap loop computes
    wrong values and only times what remains).
    """
    global launches
    if nfft_c < 3 * P:
        raise ValueError(f"nfft_c must be at least 3P = {3 * P}")
    y, S = _run("mlsa_cascade_stage_f32", x, c, weights, a, P, advance,
                _defines)
    launches += S
    return y


def cascade_unchunked_cuda(x: torch.Tensor, c: torch.Tensor,
                           weights: torch.Tensor, a: torch.Tensor, P: int,
                           advance: int, nfft: int) -> torch.Tensor:
    """The cascade on the card at every other geometry (the B3 row).

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P).  nfft, the
    folded form's transform length, is only checked (>= 2P+M+1).  Raises
    on what the kernel does not take.
    """
    global launches_unchunked
    M = c.shape[-1] - 1
    if nfft < 2 * P + M + 1:
        raise ValueError(f"nfft must be at least 2P+M+1 = {2 * P + M + 1}")
    y, S = _run("mlsa_cascade_unchunked_stage_f32", x, c, weights, a, P,
                advance)
    launches_unchunked += S
    return y


def _cascade(x, c, weights, a, P, advance, nfft):
    """The kernel on the card, the folded twin on the CPU or in twins()."""
    M = c.shape[-1] - 1
    if not x.is_cuda or use_twins():
        return taylor_cascade_folded(x, c, weights, a, P, advance, nfft)
    chunked = chunked_geometry(M, P, nfft)
    N = c.shape[-2]
    T = x.shape[-1]
    xb = x.reshape(-1, N, P)
    cb = torch.broadcast_to(c, x.shape[:-1] + c.shape[-2:]).reshape(
        -1, N, M + 1)
    if chunked is None:
        y = cascade_unchunked_cuda(xb, cb, weights, a, P, advance, nfft)
    else:
        y = cascade_chunked_cuda(xb, cb, weights, a, P, advance, chunked[1])
    return y.reshape(x.shape[:-1] + (T,))


class TaylorCascade(torch.autograd.Function):
    """Forward: the kernel on the card, the folded twin on the CPU.
    Backward: autograd through the folded twin (as the JAX VJP
    differentiates the folded XLA form)."""

    @staticmethod
    def forward(ctx, x, c, weights, a, P, advance, nfft):
        ctx.save_for_backward(x, c, weights, a)
        ctx.geometry = (P, advance, nfft)
        return _cascade(x, c, weights, a, P, advance, nfft)

    @staticmethod
    def backward(ctx, g):
        x, c, weights, a = ctx.saved_tensors
        P, advance, nfft = ctx.geometry
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, c, weights, a)]
            y = taylor_cascade_folded(*ins, P, advance, nfft)
            grads = torch.autograd.grad(y, ins, g, allow_unused=True)
        return (*grads, None, None, None)


def taylor_cascade(x, c, weights, a, P, advance, nfft, precision="HIGHEST"):
    """Fused Taylor-cascade MLSA filter.

    x (..., T); c (..., N, M+1) stage coefficients; weights/a (S+1,).
    Without a gradient to track, the call skips the autograd Function and
    its host-side bookkeeping.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, c, weights, a)):
        return TaylorCascade.apply(x, c, weights, a, P, advance, nfft)
    return _cascade(x, c, weights, a, P, advance, nfft)
