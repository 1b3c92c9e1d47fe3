"""Polynomial roots and their inverse (counterpart of
``diffsptk_tpu/ops/rootpol.py``).

``method="aberth"`` (the default) is a batched Aberth-Ehrlich
simultaneous iteration: elementwise complex arithmetic, 64 fixed steps,
no host read.  ``method="eig"`` is a host step by definition, as in the
JAX package: the eigenvalues of the companion matrices, computed by
LAPACK on the host (``eig_roots``).  Roots are unordered in both.
RootsToPolynomial is a cascade of first-order convolutions.
"""

from __future__ import annotations

import math

import torch

from ..core import BaseOp, Design, check_size, filter_values


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def aberth_roots(a: torch.Tensor, n_iter: int = 64) -> torch.Tensor:
    """a (..., M+1) coefficients in descending powers -> (..., M) complex
    roots (unordered)."""
    cdtype = _complex_dtype(a.dtype)
    a = a.to(cdtype)
    M = a.shape[-1] - 1
    monic = a / a[..., :1]

    # Initial guesses: a circle of the Cauchy bound's radius with an
    # irrational angular offset (breaks the symmetry of real inputs).
    radius = 1.0 + torch.amax(torch.abs(monic[..., 1:]), dim=-1,
                              keepdim=True)
    k = torch.arange(M, dtype=torch.float64, device=a.device)
    angles = 2 * math.pi * (k + 0.376) / M + 0.5
    z = radius.to(cdtype) * torch.exp(1j * angles).to(cdtype)

    powers = torch.arange(M, 0, -1, device=a.device)
    dcoef = monic[..., :-1] * powers
    eye = torch.eye(M, dtype=torch.bool, device=a.device)

    def horner(c, z):
        acc = torch.zeros_like(z) + c[..., :1]
        for i in range(1, c.shape[-1]):
            acc = acc * z + c[..., i:i + 1]
        return acc

    for _ in range(n_iter):
        p = horner(monic, z)
        dp = horner(dcoef, z)
        w = p / torch.where(dp == 0, 1e-30, dp)
        diff = z[..., :, None] - z[..., None, :]
        inv = torch.where(eye, 0.0, 1.0 / torch.where(eye, 1.0, diff))
        s = torch.sum(inv, dim=-1)
        z = z - w / (1.0 - w * s)
    return z


def eig_roots(a: torch.Tensor) -> torch.Tensor:
    """Roots as the eigenvalues of each polynomial's companion matrix.

    A stated host step, once per batch: the JAX package runs this method
    on the host by design (``jax.pure_callback`` into numpy's eig,
    ``diffsptk_tpu/ops/rootpol.py:8-10, 142``), since a small
    nonsymmetric eigensolve has no device path there.  Here too the whole
    batch moves to the host in one copy, all companion eigenvalues come
    from one batched LAPACK call, and the roots return to the input's
    device in its complex dtype.  A real input's companions stay real
    float64 (LAPACK's real eigensolver, a third of the time of the
    complex one that the reference's callback runs on the same values),
    a complex input's are complex128.  ``torch.linalg.eigvals``
    of a CUDA tensor would also run on the host (MAGMA's geev), but one
    matrix at a time with a hidden round trip for each.
    """
    cdtype = _complex_dtype(a.dtype)
    wide = torch.complex128 if a.is_complex() else torch.float64
    c = a.to(device="cpu", dtype=wide)
    M = c.shape[-1] - 1
    companion = torch.zeros(c.shape[:-1] + (M, M), dtype=wide)
    companion[..., 0, :] = -c[..., 1:] / c[..., :1]
    companion[..., 1:, :-1] = torch.eye(M - 1, dtype=wide)
    return torch.linalg.eigvals(companion).to(device=a.device,
                                              dtype=cdtype)


class PolynomialToRoots(BaseOp):
    """(..., M+1) coefficients (descending powers) -> (..., M) complex
    roots."""

    def __init__(self, order: int, eps: float | None = None,
                 out_format: str | int = "rectangular",
                 method: str = "aberth", dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = order + 1
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(order: int, eps: float | None) -> None:
        if order <= 0:
            raise ValueError("order must be positive.")
        if eps is not None and eps < 0:
            raise ValueError("eps must be non-negative.")

    @staticmethod
    def _design(order: int, eps: float | None = None,
                out_format: str | int = "rectangular",
                method: str = "aberth") -> Design:
        PolynomialToRoots._check(order, eps)
        if method not in ("aberth", "eig"):
            raise ValueError(f"method {method} is not supported.")
        if out_format in (0, "rectangular"):
            formatter = lambda x: x  # noqa: E731
        elif out_format in (1, "polar"):
            formatter = lambda x: torch.complex(  # noqa: E731
                torch.abs(x), torch.angle(x))
        else:
            raise ValueError(f"out_format {out_format} is not supported.")
        return Design(values={"formatter": formatter, "method": method})

    @staticmethod
    def _forward(a: torch.Tensor, *, formatter,
                 method: str = "aberth") -> torch.Tensor:
        roots = aberth_roots(a) if method == "aberth" else eig_roots(a)
        return formatter(roots)

    def forward(self, a):
        check_size(a.shape[-1], self.in_dim, "order of polynomial")
        return super().forward(a)


def roots_to_polynomial(x: torch.Tensor) -> torch.Tensor:
    """(..., M) roots -> (..., M+1) coefficients, iterated convolution
    with (1 - r_m z^-1)."""
    M = x.shape[-1]
    # [1, 0, ..., 0] built on the device: writing the scalar 1 into a
    # complex CUDA tensor copies it from the host and waits for the card
    a = torch.cat([torch.ones_like(x[..., :1]), torch.zeros_like(x)], dim=-1)
    for m in range(M):
        a = torch.cat((a[..., :1], a[..., 1:] - x[..., m:m + 1] * a[..., :-1]),
                      dim=-1)
    return a


class RootsToPolynomial(BaseOp):
    """(..., M) roots -> (..., M+1) coefficients."""

    def __init__(self, order: int, eps: float | None = None,
                 in_format: str | int = "rectangular", dtype=None,
                 device=None) -> None:
        super().__init__()
        self.in_dim = order
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(order: int, eps: float | None) -> None:
        PolynomialToRoots._check(order, eps)

    @staticmethod
    def _design(order: int, eps: float | None = None,
                in_format: str | int = "rectangular") -> Design:
        if in_format in (0, "rectangular"):
            formatter = lambda x: x  # noqa: E731
        elif in_format in (1, "polar"):
            formatter = lambda x: x.real * torch.exp(  # noqa: E731
                1j * x.imag)
        else:
            raise ValueError(f"in_format {in_format} is not supported.")
        return Design(values={"formatter": formatter})

    @staticmethod
    def _forward(x: torch.Tensor, *, formatter) -> torch.Tensor:
        return roots_to_polynomial(formatter(x))

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "number of roots")
        return super().forward(x)
