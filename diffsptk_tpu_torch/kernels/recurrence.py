"""Recursive (IIR) filters in plain torch (counterpart of
``diffsptk_tpu/kernels/recurrence.py``).

* ``first_order_recurrence`` -- y[t] = p[t] y[t-1] + x[t].  Along the last
  axis of a float32 / complex64 tensor it goes to kernels/scan.py (the
  kernel on the card, its twin on the CPU); elsewhere a log-depth
  Hillis-Steele scan.
* ``sample_wise_lpc`` -- the time-varying order-M all-pole recurrence: the
  exact block-parallel ``blocked_sample_wise_lpc`` for long sequences, the
  plain per-sample loop for short ones, the scan at M=1.
  ``chunked_sample_wise_lpc`` is the warmup-based approximation.
* ``lfilter`` -- static-coefficient IIR (direct form I), an FIR
  convolution plus the all-pole recurrence.

The JAX package computes all but the first-order scan with XLA alone, so
they stay plain torch here.  With ``axis_name`` (the time axis of a
sharded sequence: a process group, a ``parallel.mesh.Axis``, or a
(mesh, dimension name) pair) ``sample_wise_lpc`` runs the blocked form
across ranks, exactly (``parallel/filters.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .scan import DTYPES, first_order_scan_plain, scan_diff


def first_order_recurrence(x: torch.Tensor, p: torch.Tensor,
                           axis: int = -1) -> torch.Tensor:
    """Solve y[t] = p[t] * y[t-1] + x[t] (y[-1] = 0) along ``axis``.

    p broadcasts to x.  Along the last axis of a float32 / complex64
    tensor this is the scan of kernels/scan.py with its backward, which
    launches the kernel on a CUDA tensor; elsewhere the plain log-depth
    scan, differentiated by autograd.
    """
    dt = torch.promote_types(x.dtype, p.dtype)
    x = x.to(dt)
    p = torch.broadcast_to(p.to(dt), x.shape)
    if axis in (-1, x.ndim - 1) and dt in DTYPES:
        return scan_diff(p, x)
    y = first_order_scan_plain(torch.movedim(p, axis, -1),
                               torch.movedim(x, axis, -1))
    return torch.movedim(y, -1, axis)


def sample_wise_lpc(x: torch.Tensor, a: torch.Tensor,
                    zi: torch.Tensor | None = None,
                    block: int | None = 256,
                    axis_name: str | None = None) -> torch.Tensor:
    """Time-varying all-pole filter: y[t] = x[t] - sum_k a[t,k] y[t-k].

    x: (..., T); a: (..., T, M); zi: optional (..., M) initial history
    ordered [y[-1], y[-2], ...].  Long sequences take the exact
    block-parallel form; ``block=None`` forces the per-sample loop.  With
    ``axis_name`` the sequence is this rank's block of a time-sharded one
    and the blocked form carries the state across ranks.
    """
    M = a.shape[-1]
    if M == 0:
        return x
    if axis_name is not None:
        return blocked_sample_wise_lpc(x, a, zi=zi, block=block or 256,
                                       axis_name=axis_name)
    if M == 1:
        if zi is not None:
            x = torch.cat([x[..., :1] - a[..., :1, 0] * zi[..., :1],
                           x[..., 1:]], dim=-1)
        return first_order_recurrence(x, -a[..., 0])
    T = x.shape[-1]
    if block is not None and T >= 4 * block and block >= 2 * M:
        return blocked_sample_wise_lpc(x, a, zi=zi, block=block)
    return _scan_sample_wise_lpc(x, a, zi)


def _scan_sample_wise_lpc(x, a, zi=None):
    M = a.shape[-1]
    hist = (torch.zeros(x.shape[:-1] + (M,), dtype=x.dtype, device=x.device)
            if zi is None else zi.to(x.dtype))
    ys = []
    for t in range(x.shape[-1]):
        yt = x[..., t] - torch.sum(a[..., t, :] * hist, dim=-1)
        hist = torch.cat([yt[..., None], hist[..., :-1]], dim=-1)
        ys.append(yt)
    return torch.stack(ys, dim=-1)


def blocked_sample_wise_lpc(x: torch.Tensor, a: torch.Tensor,
                            zi: torch.Tensor | None = None,
                            block: int = 256,
                            axis_name: str | None = None) -> torch.Tensor:
    """EXACT block-parallel time-varying all-pole filter.

    Each block's output is superposed from M+1 responses computed with
    all blocks in parallel: the zero-state response to the block's input
    and the M homogeneous responses to unit initial histories.  The true
    initial history of each block then follows from a short sequential
    recursion of (M x M) transition maps across blocks, so the serial
    depth is block + n_blocks instead of T.

    With ``axis_name`` (x and a are this rank's block of a time-sharded
    sequence) the same decomposition crosses ranks: each rank composes
    its blocks' maps into one affine summary s_out = c + C s_in, the
    summaries are all-gathered (M + M^2 numbers a row and rank, the
    gradient passing back through the gather) and every rank folds its
    left neighbours' maps to its exact entering state: no warmup
    approximation.  ``block`` must divide the local T.
    """
    T = x.shape[-1]
    M = a.shape[-1]
    C = block
    pad = (-T) % C
    if pad and axis_name is not None:
        raise ValueError(
            "sharded blocked LPC needs block | local T: zero-padded "
            "tail blocks would corrupt the cross-rank state summary.")
    if pad:
        x = F.pad(x, (0, pad))
        a = F.pad(a, (0, 0, 0, pad))
    n = x.shape[-1] // C
    batch = x.shape[:-1]

    xs = x.reshape(*batch, n, C)
    as_ = a.reshape(*batch, n, C, M)

    # Augmented systems per block: index 0 driven by x with zero history;
    # systems 1..M homogeneous with history e_{j-1}.
    eye = torch.eye(M, dtype=x.dtype, device=x.device)
    hist = torch.cat([torch.zeros(*batch, n, 1, M, dtype=x.dtype,
                                  device=x.device),
                      eye.expand(*batch, n, M, M)], dim=-2)
    ys = []
    for c in range(C):
        yt = -torch.matmul(hist, as_[..., c, :, None])[..., 0]  # (..., n, M+1)
        yt = torch.cat([yt[..., :1] + xs[..., c, None], yt[..., 1:]], dim=-1)
        hist = torch.cat([yt[..., None], hist[..., :-1]], dim=-1)
        ys.append(yt)
    ys = torch.stack(ys, dim=-2)                     # (..., n, C, M+1)
    y0 = ys[..., 0]                                  # zero-state (..., n, C)
    H = ys[..., 1:]                                  # homogeneous (...,n,C,M)

    # Block end-state (history entering the next block):
    # s_end[i] = y[C-1-i]  =>  s_end = g + G s_start.
    tail = torch.flip(ys[..., C - M:, :], dims=(-2,))  # (..., n, M, M+1)
    g = tail[..., 0]                                 # (..., n, M)
    G = tail[..., 1:]                                # (..., n, M, M)

    # Prefix-compose the per-block affine maps s -> g + G s, carrying
    # (c, Cm) such that the state entering block i is c_i + Cm_i s_start.
    c = torch.zeros(*batch, M, dtype=x.dtype, device=x.device)
    Cm = eye.expand(*batch, M, M)
    c_in, C_in = [], []
    for k in range(n):
        c_in.append(c)
        C_in.append(Cm)
        c = g[..., k, :] + torch.matmul(G[..., k, :, :], c[..., None])[..., 0]
        Cm = torch.matmul(G[..., k, :, :], Cm)
    c_in = torch.stack(c_in, dim=-2)                 # (..., n, M)
    C_in = torch.stack(C_in, dim=-3)                 # (..., n, M, M)

    s0 = (torch.zeros(*batch, M, dtype=x.dtype, device=x.device)
          if zi is None else zi.to(x.dtype))
    if axis_name is not None:
        # cross-rank handoff: fold the left ranks' affine summaries
        from ..parallel.mesh import all_gather, as_axis
        axis = as_axis(axis_name)
        cs = all_gather(c, axis)                     # (S, ..., M)
        Cs = all_gather(Cm, axis)                    # (S, ..., M, M)
        # every rank folds every summary and keeps its left ranks' ones,
        # so that each rank's result depends on the gather and every rank
        # takes part in its backward
        left = torch.arange(axis.size, device=x.device) < axis.index
        for k in range(axis.size):
            s0 = torch.where(
                left[k], cs[k] + torch.matmul(Cs[k], s0[..., None])[..., 0],
                s0)
    s_in = c_in + torch.matmul(C_in, s0[..., None, :, None])[..., 0]
    y = y0 + torch.matmul(H, s_in[..., None])[..., 0]
    y = y.reshape(*batch, n * C)
    return y[..., :T] if pad else y


def chunked_sample_wise_lpc(x: torch.Tensor, a: torch.Tensor,
                            chunk_length: int,
                            warmup_length: int) -> torch.Tensor:
    """Block-parallel approximation of ``sample_wise_lpc``: each chunk
    re-converges from ``warmup_length`` preceding samples, and all chunks
    run at once on the batch axis."""
    T = x.shape[-1]
    C, W = chunk_length, warmup_length
    if T % C:
        raise ValueError("T must be divisible by chunk_length")
    n_chunks = T // C
    xp = F.pad(x, (W, 0))
    ap = F.pad(a, (0, 0, W, 0))
    idx = (torch.arange(n_chunks, device=x.device)[:, None] * C
           + torch.arange(W + C, device=x.device)[None, :])
    xs = xp[..., idx]                                # (..., n_chunks, W+C)
    as_ = ap[..., idx, :]                            # (..., n_chunks, W+C, M)
    ys = sample_wise_lpc(xs, as_)
    ys = ys[..., W:]
    return ys.reshape(*x.shape[:-1], T)


def _fir(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal FIR y[t] = sum_k b[k] x[t-k] via a padded unfold-dot."""
    N = b.shape[-1]
    frames = F.pad(x, (N - 1, 0)).unfold(-1, N, 1)   # (..., T, N)
    return frames @ torch.flip(b, (-1,))


def lfilter(b, a, x: torch.Tensor) -> torch.Tensor:
    """Static IIR filter (scipy.signal.lfilter semantics, zero state).

    b, a: 1-D coefficients (sequences, numpy arrays or tensors);
    normalized by a[0].
    """
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = b / a[0]
    a = a / a[0]
    v = _fir(x, b)
    M = a.shape[-1] - 1
    if M == 0:
        return v
    if M == 1:
        return first_order_recurrence(v, (-a[1]).expand(x.shape[-1:]))
    at = torch.broadcast_to(a[1:], x.shape + (M,))
    return sample_wise_lpc(v, at)
