"""Orthonormal block transforms: DCT, DST and DHT (types 1-4) and the
Walsh-Hadamard transform, with their inverses (counterpart of
``diffsptk_tpu/ops/dct.py``).

Each is one matmul over the last axis with a basis designed on the host
in float64 (the design functions are copies of the JAX package's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, check_size
from ..utils.linalg import plateau


def design_dct(L: int, dct_type: int = 2) -> np.ndarray:
    """Orthonormal DCT basis W such that y = x @ W (SPTK convention)."""
    n = np.arange(L, dtype=np.float64)
    k = np.arange(L, dtype=np.float64)
    if dct_type in (2, 4):
        n = n + 0.5
    if dct_type in (3, 4):
        k = k + 0.5
    n = n * (np.pi / ((L - 1) if dct_type == 1 else L))
    if dct_type == 1:
        c = 0.5 ** 0.5
        z0 = plateau(L, c, 1, c)
        z1 = plateau(L, 1, 2, 1)
        z = z0[None, :] * np.sqrt(z1 / (L - 1))[:, None]
    elif dct_type == 2:
        z = np.sqrt(plateau(L, 1, 2) / L)[None, :]
    elif dct_type == 3:
        z = np.sqrt(plateau(L, 1, 2) / L)[:, None]
    elif dct_type == 4:
        z = (2.0 / L) ** 0.5
    else:
        raise ValueError(f"dct_type {dct_type} is not supported.")
    return z * np.cos(k[None, :] * n[:, None])


def design_dst(L: int, dst_type: int = 2) -> np.ndarray:
    n = np.arange(1, L + 1, dtype=np.float64)
    k = np.arange(1, L + 1, dtype=np.float64)
    if dst_type in (2, 4):
        n = n - 0.5
    if dst_type in (3, 4):
        k = k - 0.5
    n = n * (np.pi / ((L + 1) if dst_type == 1 else L))
    if dst_type == 1:
        z = (2.0 / (L + 1)) ** 0.5
    elif dst_type == 2:
        z = np.sqrt(plateau(L, 2, 2, 1) / L)[None, :]
    elif dst_type == 3:
        z = np.sqrt(plateau(L, 2, 2, 1) / L)[:, None]
    elif dst_type == 4:
        z = (2.0 / L) ** 0.5
    else:
        raise ValueError(f"dst_type {dst_type} is not supported.")
    return z * np.sin(k[None, :] * n[:, None])


def design_dht(L: int, dht_type: int = 2) -> np.ndarray:
    n = np.arange(L, dtype=np.float64)
    k = np.arange(L, dtype=np.float64)
    if dht_type in (2, 4):
        n = n + 0.5
    if dht_type in (3, 4):
        k = k + 0.5
    if not 1 <= dht_type <= 4:
        raise ValueError(f"dht_type {dht_type} is not supported.")
    n = n * (2.0 * np.pi / L)
    arg = k[None, :] * n[:, None]
    cas = np.sqrt(2.0) * np.cos(arg - 0.25 * np.pi)  # cos + sin
    return cas / np.sqrt(L)


def _hadamard(L: int) -> np.ndarray:
    """Sylvester-construction Hadamard matrix (L a power of two)."""
    H = np.ones((1, 1))
    while H.shape[0] < L:
        H = np.block([[H, H], [H, -H]])
    return H


def design_wht(L: int, wht_type: str | int = "natural") -> np.ndarray:
    z = 2.0 ** -(np.log2(L) / 2)
    W = _hadamard(L).astype(np.float64)
    if wht_type in (1, "sequency"):
        sign_changes = np.sum(np.abs(np.diff(W, axis=1)), axis=1)
        W = W[np.argsort(sign_changes, kind="stable")]
    elif wht_type in (2, "natural"):
        pass
    elif wht_type in (3, "dyadic"):
        bits = int(np.log2(L))
        gray = [[int(b) for b in np.binary_repr(i, width=bits)]
                for i in range(L)]
        binary = np.bitwise_xor.accumulate(np.asarray(gray), axis=1)
        perm = [int("".join(str(int(v)) for v in row), 2) for row in binary]
        sign_changes = np.sum(np.abs(np.diff(W, axis=1)), axis=1)
        W = W[np.argsort(sign_changes, kind="stable")][perm]
    else:
        raise ValueError(f"wht_type {wht_type} is not supported.")
    return W * z


_INVERSE_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


class _MatmulOp(BaseOp):
    """y = x @ W with a basis designed on the host.  The length is the
    first positional argument or the ``*_length`` keyword."""

    def __init__(self, length: int | None = None, dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        if length is None:
            key = next(k for k in kwargs if k.endswith("_length"))
            length = kwargs.pop(key)
        self.in_dim = length
        self._setup(self._design(length, **kwargs), dtype=dtype,
                    device=device)

    @staticmethod
    def _forward(x: torch.Tensor, *, W: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, W)

    def forward(self, x):
        check_size(x.shape[-1], self.in_dim, "dimension of input")
        return super().forward(x)


class DiscreteCosineTransform(_MatmulOp):
    """DCT (..., L) -> (..., L)."""

    @staticmethod
    def _check(length: int, dct_type: int) -> None:
        if length <= 0:
            raise ValueError("dct_length must be positive.")
        if not 1 <= dct_type <= 4:
            raise ValueError("dct_type must be in [1, 4].")

    @staticmethod
    def _design(dct_length: int, dct_type: int = 2) -> Design:
        DiscreteCosineTransform._check(dct_length, dct_type)
        return Design(arrays={"W": design_dct(dct_length, dct_type)})


class InverseDiscreteCosineTransform(_MatmulOp):
    """IDCT: the basis of the conjugate type (1<->1, 2<->3, 4<->4)."""

    @staticmethod
    def _design(dct_length: int, dct_type: int = 2) -> Design:
        DiscreteCosineTransform._check(dct_length, dct_type)
        return Design(arrays={"W": design_dct(dct_length,
                                              _INVERSE_TYPE[dct_type])})


class DiscreteSineTransform(_MatmulOp):
    """DST-I..IV as an orthonormal basis matmul."""

    @staticmethod
    def _check(length: int, dst_type: int) -> None:
        if length <= 0:
            raise ValueError("dst_length must be positive.")
        if not 1 <= dst_type <= 4:
            raise ValueError("dst_type must be in [1, 4].")

    @staticmethod
    def _design(dst_length: int, dst_type: int = 2) -> Design:
        DiscreteSineTransform._check(dst_length, dst_type)
        return Design(arrays={"W": design_dst(dst_length, dst_type)})


class InverseDiscreteSineTransform(_MatmulOp):
    """Inverse DST: the basis of the conjugate type."""

    @staticmethod
    def _design(dst_length: int, dst_type: int = 2) -> Design:
        DiscreteSineTransform._check(dst_length, dst_type)
        return Design(arrays={"W": design_dst(dst_length,
                                              _INVERSE_TYPE[dst_type])})


class DiscreteHartleyTransform(_MatmulOp):
    """DHT (cas basis) as a matmul."""

    @staticmethod
    def _check(length: int, dht_type: int) -> None:
        if length <= 0:
            raise ValueError("dht_length must be positive.")
        if not 1 <= dht_type <= 4:
            raise ValueError("dht_type must be in [1, 4].")

    @staticmethod
    def _design(dht_length: int, dht_type: int = 2) -> Design:
        DiscreteHartleyTransform._check(dht_length, dht_type)
        return Design(arrays={"W": design_dht(dht_length, dht_type)})


class InverseDiscreteHartleyTransform(_MatmulOp):
    """Inverse DHT: the basis of the conjugate type."""

    @staticmethod
    def _design(dht_length: int, dht_type: int = 2) -> Design:
        DiscreteHartleyTransform._check(dht_length, dht_type)
        return Design(arrays={"W": design_dht(dht_length,
                                              _INVERSE_TYPE[dht_type])})


class WalshHadamardTransform(_MatmulOp):
    """WHT (self-inverse) in sequency, natural or dyadic order."""

    @staticmethod
    def _check(length: int) -> None:
        if length <= 0 or (length & (length - 1)) != 0:
            raise ValueError("wht_length must be a power of 2.")

    @staticmethod
    def _design(wht_length: int, wht_type: str | int = "natural") -> Design:
        WalshHadamardTransform._check(wht_length)
        return Design(arrays={"W": design_wht(wht_length, wht_type)})


# The WHT is its own inverse, as in the JAX package.
InverseWalshHadamardTransform = WalshHadamardTransform
