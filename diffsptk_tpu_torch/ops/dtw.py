"""Soft dynamic time warping with SPTK's local path constraints
(counterpart of ``diffsptk_tpu/ops/dtw.py``).

As in the JAX package, the soft-DTW recursion is a wavefront over the
anti-diagonals: one vectorized update per diagonal, over the diagonal's
cells and the batch.  Unreachable predecessors carry +inf and drop out
of the soft minimum.  Its indices are made on the tensor's device, so
the distance reads nothing back.  The hard Viterbi path
(``return_indices=True``) is a stated host step, as in the JAX package:
the distance matrix is copied to the host once and backtracked in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, filter_values

_CONSTRAINTS = {
    0: ([(1, 0), (0, 1)], False),
    1: ([(1, 0), (0, 1), (1, 1)], False),
    2: ([(1, 0), (1, 1)], False),
    3: ([(1, 0), (1, 1), (1, 2)], False),
    4: ([(1, 0), (0, 1), (1, 1)], True),
    5: ([(1, 1), (1, 2), (2, 1)], False),
    6: ([(1, 0), (1, 1), (1, 2)], True),
}


def _make_dist(metric):
    if metric in (0, "manhattan"):
        return lambda x, y: torch.sum(  # noqa: E731
            torch.abs(x[..., :, None, :] - y[..., None, :, :]), dim=-1)
    if metric in (1, "euclidean"):
        return lambda x, y: torch.sqrt(torch.sum(  # noqa: E731
            torch.square(x[..., :, None, :] - y[..., None, :, :]), dim=-1))
    if metric in (2, "squared-euclidean"):
        return lambda x, y: torch.sum(  # noqa: E731
            torch.square(x[..., :, None, :] - y[..., None, :, :]), dim=-1)
    if metric in (3, "symmetric-kl"):
        def skl(x, y):
            xx = x[..., :, None, :]
            yy = y[..., None, :, :]
            return torch.sum((xx - yy) * (torch.log(xx) - torch.log(yy)),
                             dim=-1)
        return skl
    raise ValueError(f"metric {metric} is not supported.")


def _softmin(values, gamma):
    """-gamma logsumexp(-v / gamma) over a list; +inf entries vanish.

    A cell whose candidates are all +inf stays +inf, and logsumexp never
    sees it: its backward would form 0/0 there (the JAX package's
    double where)."""
    v = torch.stack(values, dim=0)
    all_inf = torch.all(torch.isinf(v), dim=0)
    v_safe = torch.where(all_inf[None], 0.0, v)
    r = -gamma * torch.logsumexp(-v_safe / gamma, dim=0)
    return torch.where(all_inf, torch.inf, r)


def _soft_dtw_distance(D, steps, two_step, gamma):
    """The wavefront: the full R (and R_) matrices."""
    B, T1, T2 = D.shape
    dev = D.device
    R = torch.full((B, T1, T2), torch.inf, dtype=D.dtype, device=dev)
    R[:, 0, 0] = D[:, 0, 0]
    R_ = (torch.full((B, T1, T2), torch.inf, dtype=D.dtype, device=dev)
          if two_step else None)

    for d in range(1, T1 + T2 - 1):
        # the cells of this anti-diagonal
        i_lo = max(0, d - (T2 - 1))
        i_hi = min(T1 - 1, d)
        ii = torch.arange(i_lo, i_hi + 1, device=dev)
        jj = d - ii
        dcell = D[:, ii, jj]                      # (B, n)

        cands, cands_ = [], []
        for (si, sj) in steps:
            pi, pj = ii - si, jj - sj
            ok = (pi >= 0) & (pj >= 0)
            w = si + sj
            src = R_ if (two_step and (si == 0 or sj == 0)) else R
            prev = src[:, pi.clamp(0, T1 - 1), pj.clamp(0, T2 - 1)]
            prev = torch.where(ok, prev, torch.inf)
            val = dcell * w + prev
            cands.append(val)
            if two_step and not (si == 0 or sj == 0):
                cands_.append(val)

        # In place: reading R by index saves no copy of R for the
        # backward, so later writes leave earlier reads' gradients intact.
        R[:, ii, jj] = _softmin(cands, gamma)
        if two_step:
            R_[:, ii, jj] = (_softmin(cands_, gamma) if cands_
                             else torch.full_like(dcell, torch.inf))
    return R, R_


def _viterbi_np(D, lengths, steps, two_step):
    """Hard-DTW backtrace in numpy (index paths; not differentiable)."""
    B, T1, T2 = D.shape
    inf = np.inf
    R = np.full((B, T1, T2), inf)
    R_ = np.full((B, T1, T2), inf)
    P = np.full((B, T1, T2, 2), -1, dtype=np.int64)
    P_ = np.full((B, T1, T2, 2), -1, dtype=np.int64)
    R[:, 0, 0] = D[:, 0, 0]
    for i in range(T1):
        for j in range(T2):
            if i == 0 and j == 0:
                continue
            best, best_p = np.full(B, inf), np.full((B, 2), -1, np.int64)
            best_, best_p_ = np.full(B, inf), np.full((B, 2), -1, np.int64)
            for (si, sj) in steps:
                pi, pj = i - si, j - sj
                if pi < 0 or pj < 0:
                    continue
                w = si + sj
                src = R_ if (two_step and (si == 0 or sj == 0)) else R
                val = D[:, i, j] * w + src[:, pi, pj]
                upd = val < best
                best = np.where(upd, val, best)
                best_p[upd] = [pi, pj]
                if two_step and not (si == 0 or sj == 0):
                    upd_ = val < best_
                    best_ = np.where(upd_, val, best_)
                    best_p_[upd_] = [pi, pj]
            R[:, i, j] = best
            P[:, i, j] = best_p
            if two_step:
                R_[:, i, j] = best_
                P_[:, i, j] = best_p_

    paths = []
    for b in range(B):
        two = False
        ij = np.asarray(lengths[b]) - 1
        path = [ij]
        while (0 <= ij).all():
            prev = (P_ if (two_step and two) else P)[b, ij[0], ij[1]]
            if (0 <= prev).all():
                path.append(prev)
            two = bool((prev == ij).any())
            ij = prev
        paths.append(np.stack(path[::-1], axis=0))
    return paths


class DynamicTimeWarping(BaseOp):
    """Soft-DTW distance (and optionally the Viterbi path) between
    sequences."""

    def __init__(self, metric: str | int = "euclidean", p: int = 4,
                 softness: float = 1e-3, dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(softness: float, p: int) -> None:
        if softness <= 0:
            raise ValueError("softness must be positive.")
        if p not in _CONSTRAINTS:
            raise ValueError(f"local path constraint {p} is not supported.")

    @staticmethod
    def _design(metric: str | int = "euclidean", p: int = 4,
                softness: float = 1e-3) -> Design:
        DynamicTimeWarping._check(softness, p)
        steps, two_step = _CONSTRAINTS[p]
        return Design(values={"steps": steps, "two_step": two_step,
                              "softness": softness,
                              "dist_func": _make_dist(metric)})

    @staticmethod
    def _forward(x, y, lengths=None, return_indices: bool = False, *,
                 steps, two_step, softness, dist_func):
        if x.ndim == 1:
            x = x.reshape(1, -1, 1)
            y = y.reshape(1, -1, 1)
        elif x.ndim == 2:
            x = x[None]
            y = y[None]
        if x.ndim != 3 or y.ndim != 3:
            raise ValueError("x and y must be 1D, 2D, or 3D tensors.")

        D = dist_func(x, y)
        B, T1, T2 = D.shape
        R, _ = _soft_dtw_distance(D, steps, two_step, softness)
        if lengths is None:
            lengths = np.tile([[T1, T2]], (B, 1))
            dist = R[:, T1 - 1, T2 - 1] / (T1 + T2)
        else:
            lengths = np.asarray(lengths)
            index = torch.as_tensor(lengths - 1, device=D.device)
            dist = R[torch.arange(B, device=D.device), index[:, 0],
                     index[:, 1]]
            dist = dist / torch.as_tensor(lengths.sum(axis=1),
                                          dtype=dist.dtype, device=D.device)

        if return_indices:
            paths = _viterbi_np(D.detach().cpu().numpy(), lengths, steps,
                                two_step)
            return dist, [torch.as_tensor(p, device=D.device) for p in paths]
        return dist

    @staticmethod
    def merge(x, y, indices):
        """Join the aligned pairs along the Viterbi path."""
        if x.ndim != y.ndim:
            raise ValueError("x and y must have the same rank.")
        xe = x[indices[:, 0]]
        ye = y[indices[:, 1]]
        if x.ndim == 1:
            return torch.stack([xe, ye], dim=-1)
        return torch.cat([xe, ye], dim=-1)
