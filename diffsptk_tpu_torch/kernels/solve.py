"""Batched SPD solve: hand-written CUDA kernel, plain twin and autograd
Function (counterpart of ``diffsptk_tpu/kernels/pallas_solve.py``).

A (..., n, n), b (..., n) -> x = A^-1 b for every system.  On a CUDA
float32 tensor the solve is ``csrc/spd_solve.cu`` (one warp per system,
its rows in registers, 1 <= n <= 64; n is padded on the fly to a multiple
of 8, and :func:`spd_solve_padded` is that padding in torch); on a CPU
tensor it is :func:`spd_solve_plain`, the masked right-looking Cholesky
and both substitution sweeps in torch.  Both use only the lower triangle
of A.

The backward reuses the solve: for x = A^-1 b, b_bar = z = A^-1 g and
A_bar = -z x^T (only its symmetrised form is contractual: every caller
builds A by symmetric gathers).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .state import use_twins

MAX_ORDER = 64
PAD_STEP = 8
"""The kernel has one instance per order that is a multiple of this; a
system of another order is padded with the identity up to the next one."""

launches = 0
"""Number of kernel launches so far (the twin does not count)."""


def spd_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: a masked right-looking Cholesky
    plus two masked substitution sweeps, each step one batched dense
    update.  A non-positive pivot gives NaN, as in the JAX package."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)

    L = torch.zeros_like(A)
    for j in range(n):
        col = A[..., :, j]                                  # (..., n)
        inv = torch.rsqrt(col[..., j])[..., None]
        lcol = col * inv * (rows >= j)
        L = L.clone()
        L[..., :, j] = lcol
        upd = lcol * (rows > j)
        A = A - upd[..., :, None] * upd[..., None, :]

    diag = torch.diagonal(L, dim1=-2, dim2=-1)              # (..., n)

    y = torch.zeros_like(b)
    for j in range(n):
        acc = torch.sum(L[..., j, :] * y * (rows < j), dim=-1)
        yj = (b[..., j] - acc) / diag[..., j]
        y = y.clone()
        y[..., j] = yj

    x = torch.zeros_like(b)
    for j in range(n - 1, -1, -1):
        acc = torch.sum(L[..., :, j] * x * (rows > j), dim=-1)
        xj = (y[..., j] - acc) / diag[..., j]
        x = x.clone()
        x[..., j] = xj
    return x


def spd_solve_padded(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's padding in torch (a model, used by nothing on the main
    path): A bordered with the identity and b with zeros up to the next
    multiple of PAD_STEP, solved by :func:`spd_solve_plain` and cut back to
    n.  The padded columns come after every real one, so the factor and the
    forward sweep of the real entries never see them, and the backward
    sweep adds only 0 * 0 terms: the result is the unpadded solve's."""
    n = A.shape[-1]
    N = -(-n // PAD_STEP) * PAD_STEP
    Ap = torch.eye(N, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (N, N)).clone()
    Ap[..., :n, :n] = A
    bp = torch.zeros(b.shape[:-1] + (N,), dtype=b.dtype, device=b.device)
    bp[..., :n] = b
    return spd_solve_plain(Ap, bp)[..., :n]


def _check_args(A: torch.Tensor, b: torch.Tensor) -> int:
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (..., n, n), got {tuple(A.shape)}")
    if tuple(b.shape) != tuple(A.shape[:-1]):
        raise ValueError(
            f"b must be (..., n) = {tuple(A.shape[:-1])}, got "
            f"{tuple(b.shape)}")
    if A.device != b.device or A.dtype != b.dtype:
        raise ValueError("A and b must share device and dtype.")
    return A.shape[-1]


@functools.cache
def _lib():
    lib = build.library("spd_solve")
    fn = lib.spd_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spd_solve_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for every system of the batch.

    A CPU tensor takes the plain twin.  A CUDA tensor launches the kernel,
    which takes float32 with 1 <= n <= 64, and raises on anything else.
    """
    global launches
    n = _check_args(A, b)
    if not A.is_cuda or use_twins():
        return spd_solve_plain(A, b)
    if A.dtype != torch.float32:
        raise TypeError(f"the SPD solve kernel takes float32, not {A.dtype}")
    if not 1 <= n <= MAX_ORDER:
        raise ValueError(
            f"the SPD solve kernel takes 1 <= n <= {MAX_ORDER}, not {n}")
    A = A.contiguous()
    b = b.contiguous()
    x = torch.empty_like(b)
    device = A.device
    build.launch(_lib(), "spd_solve_f32", device, A.data_ptr(), b.data_ptr(),
                 x.data_ptr(), n, b.numel() // n,
                 torch.cuda.current_stream(device).cuda_stream)
    launches += 1
    return x


class SpdSolve(torch.autograd.Function):
    """Differentiable batched SPD solve on the kernel (its twin on the
    CPU)."""

    @staticmethod
    def forward(ctx, A, b):
        x = spd_solve_batched(A, b)
        ctx.save_for_backward(A, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        z = spd_solve_batched(A, g.contiguous())
        return -z[..., :, None] * x[..., None, :], z


def spd_solve_diff(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A (..., n, n), b (..., n) -> x (..., n), differentiable."""
    return SpdSolve.apply(A, b)
