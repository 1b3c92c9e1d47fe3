"""Small structured-matrix and complex helpers (plain torch).

Counterparts of ``diffsptk_tpu/utils/linalg.py``: the same gather-built
Toeplitz / Hankel matrices and the same SPD solve dispatch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import solve


def symmetric_toeplitz(r: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d, d) with X[i, j] = r[|i - j|]."""
    i = torch.arange(r.shape[-1], device=r.device)
    return r[..., (i[:, None] - i[None, :]).abs()]


def hankel(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., n, n) with X[i, j] = x[i + j], n = (d+1)//2."""
    i = torch.arange((x.shape[-1] + 1) // 2, device=x.device)
    return x[..., i[:, None] + i[None, :]]


def cas(x: torch.Tensor) -> torch.Tensor:
    """cos(x) + sin(x), the Hartley kernel."""
    return math.sqrt(2.0) * torch.cos(x - 0.25 * math.pi)


def cexp(x: torch.Tensor) -> torch.Tensor:
    """Complex exponential: exp(Re x) * e^{i Im x}."""
    return torch.exp(x.real) * torch.exp(1j * x.imag)


def clog(x: torch.Tensor) -> torch.Tensor:
    """Log magnitude of a complex array."""
    return torch.log(torch.abs(x))


def remove_gain(a: torch.Tensor, value: float = 1.0,
                return_gain: bool = False):
    """Split (..., M+1) = [K, a1..aM] into gain and [value, a1..aM]."""
    K = a[..., :1]
    a1 = a[..., 1:]
    monic = torch.cat([torch.full_like(a1[..., :1], value), a1], dim=-1)
    if return_gain:
        return K, monic
    return monic


def plateau(length: int, first: float, middle: float,
            last: float | None = None, dtype=None) -> np.ndarray:
    """Host-side constant: [first, middle, ..., middle(, last)]."""
    x = np.full(length, middle, dtype=dtype or np.float64)
    x[0] = first
    if last is not None:
        x[-1] = last
    return x


# Above this order the unrolled batch-minor form costs more than the
# masked sweeps (the same crossover the JAX package uses).
_SPD_UNROLL_MAX = 12


def _spd_solve_batch_minor(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small-n SPD solve with the batch on the last axis, unrolled in n."""
    n = A.shape[-1]
    batch_shape = A.shape[:-2]
    At = A.reshape((-1, n, n)).permute(1, 2, 0)            # (n, n, BN)
    bt = b.reshape(-1, n).T                                 # (n, BN)
    rows = torch.arange(n, device=A.device)[:, None]

    cols = [None] * n
    diag = [None] * n
    for j in range(n):
        col = At[:, j]                                      # (n, BN)
        inv = torch.rsqrt(col[j])
        lcol = col * inv * (rows >= j)
        cols[j] = lcol
        diag[j] = lcol[j]
        upd = lcol * (rows > j)
        At = At - upd[:, None, :] * upd[None, :, :]

    y = [None] * n
    for j in range(n):
        acc = bt[j]
        for k in range(j):
            acc = acc - cols[k][j] * y[k]
        y[j] = acc / diag[j]

    x = [None] * n
    for j in range(n - 1, -1, -1):
        acc = y[j]
        for k in range(j + 1, n):
            acc = acc - cols[j][k] * x[k]
        x[j] = acc / diag[j]

    return torch.stack(x, dim=-1).reshape(batch_shape + (n,))


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched symmetric-positive-definite solve A x = b.

    A: (..., n, n), b: (..., n).  The JAX package's dispatch: on the card,
    float32 systems of 12 < n <= 64 at a batch of at least 2048 take the
    hand-written SPD solve kernel (kernels/solve.py); small n at a real
    batch takes the unrolled batch-minor Cholesky; anything else the
    masked right-looking Cholesky plus two masked substitution sweeps,
    each step one batched dense update (the kernel's twin).  A
    non-positive pivot gives NaN, as in the JAX package.
    """
    dt = torch.promote_types(A.dtype, b.dtype)
    A = A.to(dt)
    b = b.to(dt)
    n = A.shape[-1]
    batch = int(np.prod(A.shape[:-2])) if A.ndim > 2 else 1
    if (A.is_cuda and dt == torch.float32
            and _SPD_UNROLL_MAX < n <= solve.MAX_ORDER and batch >= 2048):
        return solve.spd_solve_diff(A, b)
    if n <= _SPD_UNROLL_MAX and batch >= 8:
        return _spd_solve_batch_minor(A, b)
    return solve.spd_solve_plain(A, b)


def vander(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., d, d) with X[i, j] = x[j] ** i."""
    powers = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return x[..., None, :] ** powers[:, None]
