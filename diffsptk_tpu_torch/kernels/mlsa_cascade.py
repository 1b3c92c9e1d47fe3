"""Folded-plan MLSA Taylor cascade in plain torch (counterpart of
``diffsptk_tpu/kernels/mlsa_cascade.py``).

Each Taylor stage is the frame-blocked FIR of the MLSA filter with the
framing, the DFT and the lerp blend folded into static matmul plans:

* forward: ``X[n] = sum_r xq[n + r - r0] @ F_r`` -- the overlapping-frame
  gather composed with the real DFT as ``n_blk`` shifted (N, P) @ (P, 2K)
  matmuls;
* inverse + blend: the blend weight depends only on the output column, so
  ``lo*(1-lam)``, ``hi*lam`` and the last-row edge are pre-scaled (K, P)
  plan blocks of one (N, K) @ (K, 3P) matmul pair.

Long filters (M+1 > P) are tap-chunked: ``y[s] = sum_j (c[jP:jP+P] *
x)[s - jP]``, every chunk on the small (P-1) geometry whose forward
transform is a row shift of one shared plan.  The two branches,
:func:`taylor_cascade_chunked` and :func:`taylor_cascade_unchunked`, are
the plain twins of the CUDA cascade kernel's two entries
(kernels/mlsa.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def cascade_plan(nfft: int, m: int, p: int, advance: int):
    """Static plan matrices for one folded MLSA stage.

    Returns (Ffwd, Ginv_re, Ginv_im, r0, n_blk), float64 numpy:
      Ffwd    (n_blk, P, 2K)  forward DFT with framing folded in;
                              columns [0:K] real part, [K:2K] -imag.
      Ginv_re (K, 3P)         inverse DFT evaluated at the blend slots,
      Ginv_im (K, 3P)         blend weights folded in: columns
                              [0:P] lo*(1-lam), [P:2P] hi*lam,
                              [2P:3P] lo*lam (last-row edge).
    """
    P, M, z = p, m, advance
    L = 2 * P + M
    K = nfft // 2 + 1
    PADL = P + M - z
    r0 = -(-PADL // P)
    shift = r0 * P - PADL
    n_blk = -(-(shift + L) // P)

    k = np.arange(K)
    ln = np.arange(n_blk * P) - shift             # ctx position of each
    ang = 2.0 * np.pi * np.outer(ln, k) / nfft    # (n_blk*P, K)
    valid = ((0 <= ln) & (ln < L))[:, None]
    Ffwd = np.concatenate(
        [np.where(valid, np.cos(ang), 0.0),
         np.where(valid, -np.sin(ang), 0.0)], axis=1)   # (n_blk*P, 2K)
    Ffwd = Ffwd.reshape(n_blk, P, 2 * K)

    w = np.full(K, 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    lam = np.arange(P) / P
    s_lo = M + P + np.arange(P)
    s_hi = M + np.arange(P)

    def inv_block(slots, scale):
        a = 2.0 * np.pi * np.outer(k, slots) / nfft      # (K, P)
        gre = (w[:, None] * np.cos(a) / nfft) * scale
        gim = (-w[:, None] * np.sin(a) / nfft) * scale
        return gre, gim

    lo_re, lo_im = inv_block(s_lo, 1.0 - lam)
    hi_re, hi_im = inv_block(s_hi, lam)
    la_re, la_im = inv_block(s_lo, lam)
    Ginv_re = np.concatenate([lo_re, hi_re, la_re], axis=1)   # (K, 3P)
    Ginv_im = np.concatenate([lo_im, hi_im, la_im], axis=1)
    return Ffwd, Ginv_re, Ginv_im, r0, n_blk


def lane_aligned_nfft(min_nfft: int) -> int:
    """Smallest even transform length >= ``min_nfft`` whose half-spectrum
    K = nfft/2 + 1 is a multiple of 128.

    The folded cascade computes a linear convolution, so any
    nfft >= 2P+M+1 is alias-free where the blend reads; the length is a
    free parameter.  K = 128k keeps every plan a whole number of 128-wide
    tiles (and of float4 vectors in the CUDA kernel).
    """
    k = -(-(min_nfft + 2) // 256)
    return 256 * k - 2


@functools.lru_cache(maxsize=None)
def _coef_spectrum_plan(nfft: int, n_taps: int):
    k = np.arange(nfft // 2 + 1)
    t = np.arange(n_taps)
    ang = 2.0 * np.pi * np.outer(t, k) / nfft
    return np.cos(ang), -np.sin(ang)        # (n_taps, K) float64


@functools.lru_cache(maxsize=64)
def _coef_spectrum_tensors(nfft: int, n_taps: int, dtype, device):
    Cre, Cim = _coef_spectrum_plan(nfft, n_taps)
    return (torch.as_tensor(Cre, dtype=dtype, device=device),
            torch.as_tensor(Cim, dtype=dtype, device=device))


def coef_spectrum(c: torch.Tensor, nfft: int):
    """rfft(c, nfft) of the (..., M+1) stage coefficients as one small
    DFT matmul pair: re/im (..., K)."""
    Cre, Cim = _coef_spectrum_tensors(nfft, c.shape[-1], c.dtype, c.device)
    return torch.matmul(c, Cre), torch.matmul(c, Cim)


@functools.lru_cache(maxsize=64)
def plans(nfft: int, m: int, p: int, advance: int, dtype, device):
    """``cascade_plan`` as tensors of ``dtype`` on ``device``, made once
    per device: a host-to-device copy in every call would stall the
    host until the card caught up."""
    Ffwd, Ginv_re, Ginv_im, r0, n_blk = cascade_plan(nfft, m, p, advance)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return t(Ffwd), t(Ginv_re), t(Ginv_im), r0, n_blk


def _pad_rows(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero rows before/after along the frame axis (-2)."""
    return F.pad(x, (0, 0, before, after))


def _stage(xq, cre, cim, Ffwd, Ginv_re, Ginv_im, r0, n_blk, P, K):
    """One folded MLSA stage on the (..., N, P) frame grid."""
    N = xq.shape[-2]
    xpad = _pad_rows(xq, r0, n_blk - 1 - r0)
    X = None
    for r in range(n_blk):
        part = torch.matmul(xpad[..., r:r + N, :], Ffwd[r])
        X = part if X is None else X + part               # (..., N, 2K)
    Xre, Xim = X[..., :K], X[..., K:]
    Yre = Xre * cre - Xim * cim
    Yim = Xre * cim + Xim * cre
    V = torch.matmul(Yre, Ginv_re) + torch.matmul(Yim, Ginv_im)
    hi = torch.cat([V[..., 1:, P:2 * P], V[..., N - 1:, 2 * P:]], dim=-2)
    return V[..., :P] + hi


def _stage_chunked(xq, cres, cims, Ffwd, Ginv_re, Ginv_im, r0, n_blk,
                   P, K, Q):
    """One tap-chunked MLSA stage on the (..., N, P) frame grid.

    cres/cims: (..., N, Q, K) per-chunk coefficient spectra.  Chunk j's
    forward spectrum is the shared transform row-shifted by j frames.
    """
    N = xq.shape[-2]
    NE = N + Q - 1
    xpad = _pad_rows(xq, r0 + Q - 1, n_blk - 1 - r0)
    X = None
    for r in range(n_blk):
        part = torch.matmul(xpad[..., r:r + NE, :], Ffwd[r])
        X = part if X is None else X + part               # (..., NE, 2K)
    Yre = Yim = None
    for j in range(Q):
        o = Q - 1 - j
        Xre = X[..., o:o + N, :K]
        Xim = X[..., o:o + N, K:]
        cre = cres[..., j, :]
        cim = cims[..., j, :]
        yre = Xre * cre - Xim * cim
        yim = Xre * cim + Xim * cre
        Yre = yre if Yre is None else Yre + yre
        Yim = yim if Yim is None else Yim + yim
    V = torch.matmul(Yre, Ginv_re) + torch.matmul(Yim, Ginv_im)
    hi = torch.cat([V[..., 1:, P:2 * P], V[..., N - 1:, 2 * P:]], dim=-2)
    return V[..., :P] + hi


def chunk_split(c: torch.Tensor, P: int):
    """Split (..., N, M+1) stage coefficients into (..., N, Q, P) tap
    chunks (zero-padded) for the chunked cascade."""
    M = c.shape[-1] - 1
    Q = -(-(M + 1) // P)
    cpad = F.pad(c, (0, Q * P - (M + 1)))
    return cpad.reshape(c.shape[:-1] + (Q, P)), Q


def chunked_geometry(M: int, P: int, nfft: int):
    """(Q, nfft_c) when the tap-chunked branch applies, else None."""
    Q = -(-(M + 1) // P)
    nfft_c = lane_aligned_nfft(3 * P)
    if Q >= 2 and nfft_c < nfft:
        return Q, nfft_c
    return None


def taylor_cascade_chunked(x: torch.Tensor, c: torch.Tensor,
                           weights: torch.Tensor, a: torch.Tensor, P: int,
                           advance: int, nfft_c: int) -> torch.Tensor:
    """The tap-chunked cascade with chunk transform length ``nfft_c``:
    the plain twin of the CUDA cascade kernel (kernels/mlsa.py).

    x (..., T); c (..., N, M+1); weights/a (S+1,).
    """
    T = x.shape[-1]
    N = c.shape[-2]
    K = nfft_c // 2 + 1
    Ffwd, Ginv_re, Ginv_im, r0, n_blk = plans(nfft_c, P - 1, P, advance,
                                              x.dtype, x.device)
    cch, Q = chunk_split(c, P)
    cres, cims = coef_spectrum(cch, nfft_c)                # (..., N, Q, K)
    cres = cres.to(x.dtype)
    cims = cims.to(x.dtype)
    xq = x.reshape(x.shape[:-1] + (N, P))
    y = a[0] * xq
    for s in range(1, a.shape[0]):
        xq = _stage_chunked(xq, cres, cims, Ffwd, Ginv_re, Ginv_im,
                            r0, n_blk, P, K, Q) * weights[s]
        y = y + a[s] * xq
    return y.reshape(x.shape[:-1] + (T,))


def taylor_cascade_unchunked(x: torch.Tensor, c: torch.Tensor,
                             weights: torch.Tensor, a: torch.Tensor, P: int,
                             advance: int, nfft: int) -> torch.Tensor:
    """The monolithic cascade: all M+1 taps on the full transform of
    length ``nfft`` (>= 2P+M+1).  The plain twin of the CUDA cascade
    kernel's unchunked entry (kernels/mlsa.py).

    x (..., T); c (..., N, M+1); weights/a (S+1,).
    """
    M = c.shape[-1] - 1
    T = x.shape[-1]
    N = c.shape[-2]
    xq = x.reshape(x.shape[:-1] + (N, P))
    K = nfft // 2 + 1
    Ffwd, Ginv_re, Ginv_im, r0, n_blk = plans(nfft, M, P, advance, x.dtype,
                                              x.device)
    cre, cim = coef_spectrum(c, nfft)
    cre = cre.to(x.dtype)
    cim = cim.to(x.dtype)
    y = a[0] * xq
    for s in range(1, a.shape[0]):
        xq = _stage(xq, cre, cim, Ffwd, Ginv_re, Ginv_im, r0, n_blk,
                    P, K) * weights[s]
        y = y + a[s] * xq
    return y.reshape(x.shape[:-1] + (T,))


def taylor_cascade_folded(x: torch.Tensor, c: torch.Tensor,
                          weights: torch.Tensor, a: torch.Tensor,
                          P: int, advance: int, nfft: int,
                          precision=None) -> torch.Tensor:
    """Taylor-cascade MLSA filter, folded-plan formulation.

    x (..., T) float; c (..., N, M+1) stage coefficients (shared across
    stages); weights/a (S+1,) Taylor stage weights.  Every matmul runs in
    full precision; ``precision`` is accepted for the JAX signature.
    """
    M = c.shape[-1] - 1
    chunked = chunked_geometry(M, P, nfft)
    if chunked is not None:
        return taylor_cascade_chunked(x, c, weights, a, P, advance,
                                      chunked[1])

    return taylor_cascade_unchunked(x, c, weights, a, P, advance, nfft)
