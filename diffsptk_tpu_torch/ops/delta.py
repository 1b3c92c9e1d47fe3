"""Delta features and MLPG trajectory smoothing (counterpart of
``diffsptk_tpu/ops/delta.py``).

Delta windows are designed on the host from coefficients or regression
widths and applied as one sum over a window of frames; MLPG's closed-form
matrix (W'W)^-1 W' is made on the host (numpy's inverse, as the JAX
package does) and applied with one einsum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import BaseOp, Design, filter_values


def design_delta_window(seed, static_out: bool = True) -> np.ndarray:
    """(H, W) stack of delta windows from coefficient lists or widths."""
    if not isinstance(seed, (tuple, list)):
        raise ValueError("seed must be tuple or list.")
    if isinstance(seed[0], (tuple, list)):
        seed_2d = list(seed)
        if static_out:
            seed_2d = [[1.0]] + seed_2d
        max_len = max(len(c) for c in seed_2d)
        if max_len % 2 == 0:
            max_len += 1
        window = []
        for coefficients in seed_2d:
            diff = max_len - len(coefficients)
            if diff % 2 == 0:
                lp = rp = diff // 2
            else:
                lp, rp = (diff - 1) // 2, (diff + 1) // 2
            window.append(np.pad(np.asarray(coefficients, np.float64),
                                 (lp, rp)))
    else:
        if min(seed) <= 0:
            raise ValueError(
                "The width of regression coefficients must be positive.")
        max_len = max(seed) * 2 + 1
        window = []
        if static_out:
            w = np.zeros(max_len)
            w[(max_len - 1) // 2] = 1.0
            window.append(w)
        n = seed[0]
        z = 1 / (n * (n + 1) * (2 * n + 1) / 3)
        j = np.arange(-n, n + 1, dtype=np.float64)
        pad = (max_len - (2 * n + 1)) // 2
        window.append(np.pad(j * z, pad))
        if len(seed) >= 2:
            n = seed[1]
            a0 = 2 * n + 1
            a1 = a0 * n * (n + 1) / 3
            a2 = a1 * (3 * n * n + 3 * n - 1) / 5
            z = 1 / (2 * (a2 * a0 - a1 * a1))
            j = np.arange(-n, n + 1, dtype=np.float64)
            pad = (max_len - (2 * n + 1)) // 2
            window.append(np.pad((a0 * j * j - a1) * z, pad))
        if len(seed) >= 3:
            raise ValueError("3rd order regression is not supported.")
    return np.stack(window)


class Delta(BaseOp):
    """(..., T, D) -> (..., T, D*H) delta-augmented features."""

    def __init__(self, seed=[[-0.5, 0.0, 0.5]], static_out: bool = True,
                 dtype=None, device=None) -> None:
        super().__init__()
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(seed) -> None:
        if not isinstance(seed, (tuple, list)):
            raise ValueError("seed must be tuple or list.")

    @staticmethod
    def _design(seed=[[-0.5, 0.0, 0.5]], static_out: bool = True) -> Design:
        return Design(arrays={"window": design_delta_window(seed,
                                                            static_out)})

    @staticmethod
    def _forward(x: torch.Tensor, *, window: torch.Tensor) -> torch.Tensor:
        d = x.ndim
        if d == 2:
            x = x[None]
        B, T, D = x.shape
        H, W = window.shape
        pad = (W - 1) // 2
        # the window's frames, the edges repeated
        idx = torch.clamp(torch.arange(T, device=x.device)[:, None]
                          + torch.arange(W, device=x.device)[None, :] - pad,
                          0, T - 1)
        frames = x[:, idx, :]                       # (B, T, W, D)
        y = torch.einsum("btwd,hw->bthd", frames, window)
        y = y.reshape(B, T, H * D)
        if d == 2:
            y = y[0]
        return y


class MaximumLikelihoodParameterGeneration(BaseOp):
    """Static and delta means (..., T, DH) -> smoothed trajectory
    (..., T, D)."""

    def __init__(self, size: int, seed=[[-0.5, 0.0, 0.5],
                                        [1.0, -2.0, 1.0]],
                 dtype=None, device=None) -> None:
        super().__init__()
        self.in_dim = size
        self._setup(self._design(**filter_values(locals())), dtype=dtype,
                    device=device)

    @staticmethod
    def _check(size: int) -> None:
        if size <= 0:
            raise ValueError("size must be positive.")

    @staticmethod
    def _design(size: int, seed=[[-0.5, 0.0, 0.5],
                                 [1.0, -2.0, 1.0]]) -> Design:
        MaximumLikelihoodParameterGeneration._check(size)
        window = design_delta_window(seed, static_out=True)
        if isinstance(seed[0], (tuple, list)):
            th = [0] + [len(c) // 2 for c in seed]
        else:
            th = [0] + list(seed)
        th = np.asarray(th, np.float64)[:, None]

        H, L = window.shape
        N = (L - 1) // 2
        T = size
        W = np.zeros((T * H, T))
        for t in range(T):
            hs, he = H * t, H * t + H
            ts, te = t - N, t - N + L
            if ts < 0:
                W[hs:he, :te] = window[:, -ts:] * (th <= t)
            elif T < te:
                W[hs:he, ts:] = window[:, : T - ts] * (th < T - t)
            else:
                W[hs:he, ts:te] = window
        WS = W.T
        M = np.linalg.inv(WS @ W) @ WS  # (T, T*H)
        return Design(arrays={"M": M})

    @staticmethod
    def _forward(mean: torch.Tensor, *, M: torch.Tensor) -> torch.Tensor:
        T = mean.shape[-2]
        H = M.shape[-1] // T
        u = mean.reshape(*mean.shape[:-2], T * H, -1)
        return torch.einsum("...Td,tT->...td", u, M)
