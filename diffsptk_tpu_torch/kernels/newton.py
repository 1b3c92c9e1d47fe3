"""Toeplitz+Hankel Newton solve: hand-written CUDA kernel, plain twin and
autograd Functions (counterpart of ``diffsptk_tpu/kernels/pallas_newton.py``).

Each Newton step of (mel-generalized) cepstral analysis solves, per
frame, the SPD system

    (Toeplitz(p) + Hankel(q)) x = b,   A[i, j] = p[|i-j|] + q[i+j]

lane-major: p_t (n, B), q_t (2n-1, B), b_t (n, B) -> x_t (n, B).  mgcep's
two generators differ (:func:`toephank_solve`); mcep's come from one
correlation vector, p = rt[:n] and q = rt (:func:`newton_solve_t`).  On a
CUDA float32 tensor the solve is ``csrc/newton.cu``, which stages mcep's
one generator once; on a CPU tensor it is :func:`toephank_solve_plain`,
which repeats the kernel's arithmetic in torch.

The backward pass reuses the same solve: for x = A^-1 b, b_bar = z =
A^-1 g, and with dA = -z x^T, p_bar[k] = sum_{|i-j|=k} dA[i, j] and
q_bar[k] = sum_{i+j=k} dA[i, j], static one-hot contractions (mcep's
rt_bar is their sum, folded into one).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.profiling import span
from . import build
from .state import use_twins

MAX_ORDER = 33

launches = 0
"""Number of kernel launches so far, both entries (the twin does not
count)."""

launches_toephank = 0
"""Of those, the launches of the two-generator entry (mgcep)."""


def toephank_solve_plain(p_t: torch.Tensor, q_t: torch.Tensor,
                         b_t: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: the same right-looking Cholesky
    and both sweeps, every scalar of one system a (B,) vector."""
    n = b_t.shape[0]
    A = {}
    for i in range(n):
        for j in range(i + 1):
            A[(i, j)] = p_t[i - j] + q_t[i + j]
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


def newton_solve_plain(rt_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """The twin on mcep's one generator: p = rt[:n], q = rt."""
    return toephank_solve_plain(rt_t[:b_t.shape[0]], rt_t, b_t)


def _check_args(p_t: torch.Tensor, q_t: torch.Tensor,
                b_t: torch.Tensor) -> int:
    if b_t.ndim != 2 or q_t.ndim != 2 or p_t.ndim != 2:
        raise ValueError("p_t must be (n, B), q_t (2n-1, B) and b_t (n, B).")
    n, B = b_t.shape
    if q_t.shape != (2 * n - 1, B):
        raise ValueError(
            f"q_t must be (2n-1, B) = {(2 * n - 1, B)}, got "
            f"{tuple(q_t.shape)}.")
    if p_t.shape != (n, B):
        raise ValueError(
            f"p_t must be (n, B) = {(n, B)}, got {tuple(p_t.shape)}.")
    if (p_t.device != b_t.device or q_t.device != b_t.device
            or p_t.dtype != b_t.dtype or q_t.dtype != b_t.dtype):
        raise ValueError("p_t, q_t and b_t must share device and dtype.")
    return n


def _check_one(rt_t: torch.Tensor, b_t: torch.Tensor) -> int:
    """The one-generator entry's checks: rt_t (2n-1, B), b_t (n, B)."""
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
    fn = lib.toephank_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@span("kernel.newton")
def _launch(p_t, q_t, b_t, n: int) -> torch.Tensor:
    """Launch the kernel; ``p_t is q_t`` marks mcep's one generator, which
    the kernel reads as the first n rows of q_t."""
    global launches, launches_toephank
    if q_t.dtype != torch.float32:
        raise TypeError(f"the Newton kernel takes float32, not {q_t.dtype}")
    if n > MAX_ORDER:
        raise ValueError(f"the Newton kernel takes n <= {MAX_ORDER}, not {n}")
    if not (q_t.is_contiguous() and b_t.is_contiguous()
            and (p_t is q_t or p_t.is_contiguous())):
        raise ValueError("the Newton kernel takes contiguous tensors")
    B = b_t.shape[1]
    x_t = torch.empty_like(b_t)
    stream = torch.cuda.current_stream(q_t.device).cuda_stream
    build.launch(_lib(), "toephank_solve_f32", q_t.device, p_t.data_ptr(),
                 q_t.data_ptr(), b_t.data_ptr(), x_t.data_ptr(), n, B,
                 stream)
    launches += 1
    if p_t is not q_t:
        launches_toephank += 1
    return x_t


def toephank_solve_lane_major(p_t: torch.Tensor, q_t: torch.Tensor,
                              b_t: torch.Tensor) -> torch.Tensor:
    """Solve (Toeplitz(p) + Hankel(q)) x = b for every column.

    A CPU tensor takes the plain twin.  A CUDA tensor launches the kernel,
    which takes contiguous float32 with n <= 33, and raises on anything
    else.
    """
    n = _check_args(p_t, q_t, b_t)
    if not q_t.is_cuda or use_twins():
        return toephank_solve_plain(p_t, q_t, b_t)
    return _launch(p_t, q_t, b_t, n)


def newton_solve_lane_major(rt_t: torch.Tensor,
                            b_t: torch.Tensor) -> torch.Tensor:
    """Solve (Toeplitz(rt[:n]) + Hankel(rt)) x = b for every column: the
    kernel's one-generator entry (the same rules as
    :func:`toephank_solve_lane_major`)."""
    n = _check_one(rt_t, b_t)
    if not rt_t.is_cuda or use_twins():
        return newton_solve_plain(rt_t, b_t)
    return _launch(rt_t, rt_t, b_t, n)


@functools.lru_cache(maxsize=64)
def _structure_onehots(n: int, dtype, device):
    """(n, n, n) Toeplitz one-hot Sp[i, j, k] = [|i-j| == k] and
    (n, n, 2n-1) Hankel one-hot Sq[i, j, k] = [i+j == k]."""
    i = np.arange(n)[:, None, None]
    j = np.arange(n)[None, :, None]
    Sp = (np.abs(i - j) == np.arange(n)).astype(np.float64)
    Sq = ((i + j) == np.arange(2 * n - 1)).astype(np.float64)
    return (torch.as_tensor(Sp, dtype=dtype, device=device),
            torch.as_tensor(Sq, dtype=dtype, device=device))


@functools.lru_cache(maxsize=64)
def _structure_onehot(n: int, dtype, device) -> torch.Tensor:
    """(n, n, 2n-1) with S[i, j, k] = [|i-j| == k] + [i+j == k]: mcep's
    two one-hots in one."""
    Sp, Sq = _structure_onehots(n, dtype, device)
    return Sq + torch.nn.functional.pad(Sp, (0, n - 1))


class ToephankSolveT(torch.autograd.Function):
    """Differentiable lane-major (Toeplitz(p) + Hankel(q)) solve."""

    @staticmethod
    def forward(ctx, p_t, q_t, b_t):
        x_t = toephank_solve_lane_major(p_t, q_t, b_t)
        ctx.save_for_backward(p_t, q_t, x_t)
        return x_t

    @staticmethod
    def backward(ctx, g):
        p_t, q_t, x_t = ctx.saved_tensors
        n = x_t.shape[0]
        z = toephank_solve_lane_major(p_t, q_t, g.contiguous())
        Sp, Sq = _structure_onehots(n, x_t.dtype, x_t.device)
        dA = -z[:, None, :] * x_t[None, :, :]                # (n, n, B)
        dp = torch.einsum("ijb,ijk->kb", dA, Sp)
        dq = torch.einsum("ijb,ijk->kb", dA, Sq)
        return dp, dq, z


def toephank_solve_t(p_t: torch.Tensor, q_t: torch.Tensor,
                     b_t: torch.Tensor) -> torch.Tensor:
    """p_t (n, B), q_t (2n-1, B), b_t (n, B) -> x_t (n, B),
    differentiable."""
    return ToephankSolveT.apply(p_t, q_t, b_t)


def toephank_solve(p: torch.Tensor, q: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Solve (Toeplitz(p) + Hankel(q)) x = b, batched and differentiable:
    p (..., n), q (..., 2n-1), b (..., n) -> x (..., n), the JAX
    package's row-major entry.  The systems go lane-major for the solve
    and back."""
    n = b.shape[-1]
    if p.shape[-1] != n or q.shape[-1] != 2 * n - 1:
        raise ValueError(
            "p must have n entries and q must have 2n-1 entries.")
    batch = b.shape[:-1]
    p_t = p.reshape(-1, n).T.contiguous()
    q_t = q.reshape(-1, 2 * n - 1).T.contiguous()
    b_t = b.reshape(-1, n).T.contiguous()
    return toephank_solve_t(p_t, q_t, b_t).T.reshape(batch + (n,))


class NewtonSolveT(torch.autograd.Function):
    """Differentiable lane-major one-generator (mcep) solve."""

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
