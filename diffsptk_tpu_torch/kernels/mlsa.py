"""Taylor MLSA cascade: hand-written CUDA kernel and autograd Function
(counterpart of ``diffsptk_tpu/kernels/pallas_mlsa.py``).

On a CUDA float32 tensor the S stages run as S launches of
``csrc/mlsa_cascade.cu``, the (B, N, P) state in two ping-pong buffers:
through its tap-chunked entry where the geometry takes the chunked branch
(the counterpart of the TPU's chunked kernel, B2), through its unchunked
entry otherwise (the monolithic kernel, B3).  On a CPU tensor the cascade
is its plain twin, ``mlsa_cascade.taylor_cascade_folded``.  The per-frame
coefficient spectra stay one small matmul outside the kernel.

``precision`` keeps the JAX signature.  Every value runs the fp32 kernel,
which is at least the accuracy class (HIGH) that inverse-then-forward
round trips need; a cheaper class is future work.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .mlsa_cascade import (
    cascade_plan,
    chunk_split,
    chunked_geometry,
    coef_spectrum,
    plans,
    taylor_cascade_folded,
)
from .state import use_twins

PRECISIONS = ("DEFAULT", "HIGH", "HIGHEST")

launches = 0
"""Launches of the tap-chunked entry so far, one per stage (the twin does
not count)."""

launches_unchunked = 0
"""Launches of the unchunked entry so far, one per stage."""


@functools.cache
def _lib(defines=()):
    lib = build.library("mlsa_cascade", defines)
    fn = lib.mlsa_cascade_stage_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_unchunked():
    fn = build.library("mlsa_cascade").mlsa_cascade_unchunked_stage_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_args(x, c, weights, a, P):
    if not (x.is_cuda and c.is_cuda):
        raise ValueError("the cascade kernel takes CUDA tensors")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("the cascade kernel takes float32")
    B, N, P_ = x.shape
    if P_ != P or c.shape[:2] != (B, N):
        raise ValueError(
            f"x must be (B, N, P) and c (B, N, M+1); got {tuple(x.shape)} "
            f"and {tuple(c.shape)}")
    if weights.shape != a.shape:
        raise ValueError("weights and a must both be (S+1,)")
    wa = torch.stack([weights, a]).to(device=x.device,
                                      dtype=torch.float32).contiguous()
    return x.contiguous(), wa


def _run_stages(launch, x, wa):
    """Launch stages 1..S, the state ping-ponging between two buffers;
    ``launch(src, dst, y, s)`` enqueues stage s and returns its error."""
    S = wa.shape[1] - 1
    bufs = (torch.empty_like(x), torch.empty_like(x))
    y = torch.empty_like(x)
    src = x
    with torch.cuda.device(x.device):
        for s in range(1, S + 1):
            dst = bufs[s % 2]
            build.check(launch(src, dst, y, s), "mlsa_cascade stage")
            src = dst
    return y


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
    x, wa = _check_args(x, c, weights, a, P)
    if wa.shape[1] == 1:
        return wa[1, 0] * x
    B, N, _ = x.shape
    S = wa.shape[1] - 1
    K = nfft_c // 2 + 1
    cch, Q = chunk_split(c, P)                             # (B, N, Q, P)
    cre, cim = (t.contiguous() for t in coef_spectrum(cch, nfft_c))
    Ffwd, Gre, Gim, r0, n_blk = plans(nfft_c, P - 1, P, advance,
                                      torch.float32, x.device)
    fn = _lib(_defines)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(src, dst, y, s):
        global launches
        err = fn(src.data_ptr(), x.data_ptr(), dst.data_ptr(), y.data_ptr(),
                 cre.data_ptr(), cim.data_ptr(), Ffwd.data_ptr(),
                 Gre.data_ptr(), Gim.data_ptr(), wa.data_ptr(), B, N, P, K,
                 Q, n_blk, r0, S, s, stream)
        launches += 1
        return err

    return _run_stages(launch, x, wa)


@functools.lru_cache(maxsize=16)
def unchunked_plans(nfft: int, m: int, p: int, advance: int, device):
    """The full-transform plans as float32 on ``device``, the half
    spectrum zero-padded from K = nfft/2+1 to a multiple of 4 bins (the
    kernel reads float4 vectors; padded bins add nothing).  Returns
    (Ffwd (n_blk, P, 2Kp), Gre (Kp, 3P), Gim (Kp, 3P), r0, n_blk, K)."""
    Ffwd, Gre, Gim, r0, n_blk = cascade_plan(nfft, m, p, advance)
    K = nfft // 2 + 1
    Kp = -(-K // 4) * 4
    F = np.zeros((n_blk, p, 2 * Kp))
    F[..., :K] = Ffwd[..., :K]
    F[..., Kp:Kp + K] = Ffwd[..., K:]
    G = np.zeros((2, Kp, 3 * p))
    G[0, :K] = Gre
    G[1, :K] = Gim

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return t(F), t(G[0]), t(G[1]), r0, n_blk, K


def cascade_unchunked_cuda(x: torch.Tensor, c: torch.Tensor,
                           weights: torch.Tensor, a: torch.Tensor, P: int,
                           advance: int, nfft: int) -> torch.Tensor:
    """The unchunked cascade on the card: all M+1 taps on the transform of
    length ``nfft`` (>= 2P+M+1).

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P).  Raises on
    what the kernel does not take.
    """
    x, wa = _check_args(x, c, weights, a, P)
    if wa.shape[1] == 1:
        return wa[1, 0] * x
    B, N, _ = x.shape
    S = wa.shape[1] - 1
    M = c.shape[-1] - 1
    if nfft < 2 * P + M + 1:
        raise ValueError(f"nfft must be at least 2P+M+1 = {2 * P + M + 1}")
    Ffwd, Gre, Gim, r0, n_blk, K = unchunked_plans(nfft, M, P, advance,
                                                   x.device)
    Kp = Gre.shape[0]
    cre, cim = (F.pad(t, (0, Kp - K)).contiguous()
                for t in coef_spectrum(c, nfft))           # (B, N, Kp)
    fn = _lib_unchunked()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch(src, dst, y, s):
        global launches_unchunked
        err = fn(src.data_ptr(), x.data_ptr(), dst.data_ptr(), y.data_ptr(),
                 cre.data_ptr(), cim.data_ptr(), Ffwd.data_ptr(),
                 Gre.data_ptr(), Gim.data_ptr(), wa.data_ptr(), B, N, P, Kp,
                 n_blk, r0, S, s, stream)
        launches_unchunked += 1
        return err

    return _run_stages(launch, x, wa)


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
        N = c.shape[-2]
        T = x.shape[-1]
        xb = x.reshape(-1, N, P)
        cb = torch.broadcast_to(c, x.shape[:-1] + c.shape[-2:]).reshape(
            -1, N, M + 1)
        if chunked is None:
            y = cascade_unchunked_cuda(xb, cb, weights, a, P, advance, nfft)
        else:
            y = cascade_chunked_cuda(xb, cb, weights, a, P, advance,
                                     chunked[1])
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
