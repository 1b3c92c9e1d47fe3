"""Toeplitz+Hankel Newton solve: hand-written CUDA kernel, plain twin and
autograd Function (counterpart of ``diffsptk_tpu/kernels/pallas_newton.py``).

Each mcep Newton step solves, per frame, the SPD system

    (Toeplitz(rt[:n]) + Hankel(rt)) x = b,   A[i, j] = rt[|i-j|] + rt[i+j]

lane-major: rt_t (2n-1, B), b_t (n, B) -> x_t (n, B).  On a CUDA float32
tensor the solve is ``csrc/newton.cu``; on a CPU tensor it is
:func:`newton_solve_plain`, which repeats the kernel's arithmetic in torch.

The backward pass reuses the same solve: for x = A(rt)^-1 b,
b_bar = A^-1 g and rt_bar[k] = -sum_{|i-j|=k or i+j=k} (A^-1 g)_i x_j,
a static one-hot contraction.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .state import use_twins

MAX_ORDER = 33

launches = 0
"""Number of kernel launches so far (the twin does not count)."""


def newton_solve_plain(rt_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: the same right-looking Cholesky
    and both sweeps, every scalar of one system a (B,) vector."""
    n = b_t.shape[0]
    A = {}
    for i in range(n):
        for j in range(i + 1):
            A[(i, j)] = rt_t[i - j] + rt_t[i + j]
    dinv = [None] * n
    for j in range(n):
        inv = torch.rsqrt(A[(j, j)])
        dinv[j] = inv
        for i in range(j + 1, n):
            A[(i, j)] = A[(i, j)] * inv
        for k in range(j + 1, n):
            for i in range(k, n):
                A[(i, k)] = A[(i, k)] - A[(i, j)] * A[(k, j)]
    y = [None] * n
    for j in range(n):
        acc = b_t[j]
        for k in range(j):
            acc = acc - A[(j, k)] * y[k]
        y[j] = acc * dinv[j]
    x = [None] * n
    for j in range(n - 1, -1, -1):
        acc = y[j]
        for k in range(j + 1, n):
            acc = acc - A[(k, j)] * x[k]
        x[j] = acc * dinv[j]
    return torch.stack(x, dim=0)


def _check_args(rt_t: torch.Tensor, b_t: torch.Tensor) -> int:
    if b_t.ndim != 2 or rt_t.ndim != 2:
        raise ValueError("rt_t must be (2n-1, B) and b_t (n, B).")
    n, B = b_t.shape
    if rt_t.shape != (2 * n - 1, B):
        raise ValueError(
            f"rt_t must be (2n-1, B) = {(2 * n - 1, B)}, got "
            f"{tuple(rt_t.shape)}.")
    if rt_t.device != b_t.device or rt_t.dtype != b_t.dtype:
        raise ValueError("rt_t and b_t must share device and dtype.")
    return n


@functools.cache
def _lib():
    lib = build.library("newton")
    fn = lib.newton_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def newton_solve_lane_major(rt_t: torch.Tensor,
                            b_t: torch.Tensor) -> torch.Tensor:
    """Solve (Toeplitz(rt[:n]) + Hankel(rt)) x = b for every column.

    A CPU tensor takes the plain twin.  A CUDA tensor launches the kernel,
    which takes contiguous float32 with n <= 33, and raises on anything
    else.
    """
    global launches
    n = _check_args(rt_t, b_t)
    if not rt_t.is_cuda or use_twins():
        return newton_solve_plain(rt_t, b_t)
    if rt_t.dtype != torch.float32:
        raise TypeError(f"the Newton kernel takes float32, not {rt_t.dtype}")
    if n > MAX_ORDER:
        raise ValueError(f"the Newton kernel takes n <= {MAX_ORDER}, not {n}")
    if not (rt_t.is_contiguous() and b_t.is_contiguous()):
        raise ValueError("the Newton kernel takes contiguous tensors")
    B = b_t.shape[1]
    x_t = torch.empty_like(b_t)
    stream = torch.cuda.current_stream(rt_t.device).cuda_stream
    with torch.cuda.device(rt_t.device):
        err = _lib()(rt_t.data_ptr(), b_t.data_ptr(), x_t.data_ptr(), n, B,
                     stream)
    build.check(err, "newton_solve_f32")
    launches += 1
    return x_t


@functools.lru_cache(maxsize=64)
def _structure_onehot(n: int, dtype, device) -> torch.Tensor:
    """(n, n, 2n-1) with S[i, j, k] = [|i-j| == k] + [i+j == k]."""
    i = np.arange(n)[:, None, None]
    j = np.arange(n)[None, :, None]
    k = np.arange(2 * n - 1)[None, None, :]
    S = ((np.abs(i - j) == k).astype(np.float64)
         + ((i + j) == k).astype(np.float64))
    return torch.as_tensor(S, dtype=dtype, device=device)


class NewtonSolveT(torch.autograd.Function):
    """Differentiable lane-major Toeplitz+Hankel SPD solve."""

    @staticmethod
    def forward(ctx, rt_t, b_t):
        x_t = newton_solve_lane_major(rt_t, b_t)
        ctx.save_for_backward(rt_t, x_t)
        return x_t

    @staticmethod
    def backward(ctx, g):
        rt_t, x_t = ctx.saved_tensors
        n = x_t.shape[0]
        z = newton_solve_lane_major(rt_t, g.contiguous())
        S = _structure_onehot(n, x_t.dtype, x_t.device)
        dA = -z[:, None, :] * x_t[None, :, :]                # (n, n, B)
        drt = torch.einsum("ijb,ijk->kb", dA, S)
        return drt, z


def newton_solve_t(rt_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """rt_t (2n-1, B), b_t (n, B) -> x_t (n, B), differentiable."""
    return NewtonSolveT.apply(rt_t, b_t)
