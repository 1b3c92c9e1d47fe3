"""Tap-chunked Taylor MLSA cascade: hand-written CUDA kernel and autograd
Function (counterpart of ``diffsptk_tpu/kernels/pallas_mlsa.py``).

On a CUDA float32 tensor whose geometry takes the tap-chunked branch, the
S stages run as S launches of ``csrc/mlsa_cascade.cu``, the (B, N, P)
state in two ping-pong buffers.  On a CPU tensor the cascade is its plain
twin, ``mlsa_cascade.taylor_cascade_folded``.  The per-frame chunk
spectra stay one small matmul outside the kernel.

``precision`` keeps the JAX signature.  Every value runs the fp32 kernel,
which is at least the accuracy class (HIGH) that inverse-then-forward
round trips need; a cheaper class is future work.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .mlsa_cascade import (
    chunk_split,
    chunked_geometry,
    coef_spectrum,
    plans,
    taylor_cascade_folded,
)
from .state import use_twins

PRECISIONS = ("DEFAULT", "HIGH", "HIGHEST")

launches = 0
"""Number of kernel launches so far, one per stage (the twin does not
count)."""


@functools.cache
def _lib(defines=()):
    lib = build.library("mlsa_cascade", defines)
    fn = lib.mlsa_cascade_stage_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cascade_chunked_cuda(x: torch.Tensor, c: torch.Tensor,
                         weights: torch.Tensor, a: torch.Tensor, P: int,
                         advance: int, nfft_c: int,
                         _defines=()) -> torch.Tensor:
    """The tap-chunked cascade on the card.

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P); nfft_c is
    the chunk transform length.  Raises on what the kernel does not take.
    ``_defines`` builds the kernel with those macros set: the ablation
    variants of tools/torch_cascade_ablation.py, which compute wrong
    values and only time what remains.
    """
    global launches
    if not (x.is_cuda and c.is_cuda):
        raise ValueError("cascade_chunked_cuda takes CUDA tensors")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("the cascade kernel takes float32")
    B, N, P_ = x.shape
    if P_ != P or c.shape[:2] != (B, N):
        raise ValueError(
            f"x must be (B, N, P) and c (B, N, M+1); got {tuple(x.shape)} "
            f"and {tuple(c.shape)}")
    S = a.shape[0] - 1
    if weights.shape != a.shape:
        raise ValueError("weights and a must both be (S+1,)")
    x = x.contiguous()
    wa = torch.stack([weights, a]).to(device=x.device,
                                      dtype=torch.float32).contiguous()
    if S == 0:
        return wa[1, 0] * x
    K = nfft_c // 2 + 1
    cch, Q = chunk_split(c, P)                             # (B, N, Q, P)
    cre, cim = coef_spectrum(cch, nfft_c)                  # (B, N, Q, K)
    cre = cre.contiguous()
    cim = cim.contiguous()
    Ffwd, Gre, Gim, r0, n_blk = plans(nfft_c, P - 1, P, advance,
                                      torch.float32, x.device)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    y = torch.empty_like(x)
    fn = _lib(_defines)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    with torch.cuda.device(x.device):
        for s in range(1, S + 1):
            dst = bufs[s % 2]
            err = fn(src.data_ptr(), x.data_ptr(), dst.data_ptr(),
                     y.data_ptr(), cre.data_ptr(), cim.data_ptr(),
                     Ffwd.data_ptr(), Gre.data_ptr(), Gim.data_ptr(),
                     wa.data_ptr(), B, N, P, K, Q, n_blk, r0, S, s, stream)
            build.check(err, "mlsa_cascade_stage_f32")
            launches += 1
            src = dst
    return y


class TaylorCascade(torch.autograd.Function):
    """Forward: the kernel on the card, the folded twin on the CPU.
    Backward: autograd through the folded twin (as the JAX VJP
    differentiates the folded XLA form)."""

    @staticmethod
    def forward(ctx, x, c, weights, a, P, advance, nfft):
        ctx.save_for_backward(x, c, weights, a)
        ctx.geometry = (P, advance, nfft)
        M = c.shape[-1] - 1
        chunked = chunked_geometry(M, P, nfft)
        if not x.is_cuda or use_twins():
            return taylor_cascade_folded(x, c, weights, a, P, advance, nfft)
        if chunked is None:
            raise NotImplementedError(
                "the unchunked cascade kernel is not ported yet; this "
                "geometry runs on the card with cascade='folded'")
        N = c.shape[-2]
        T = x.shape[-1]
        xb = x.reshape(-1, N, P)
        cb = torch.broadcast_to(c, x.shape[:-1] + c.shape[-2:]).reshape(
            -1, N, M + 1)
        y = cascade_chunked_cuda(xb, cb, weights, a, P, advance, chunked[1])
        return y.reshape(x.shape[:-1] + (T,))

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
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return TaylorCascade.apply(x, c, weights, a, P, advance, nfft)
