"""Static FIR filterbank application (counterpart of
``diffsptk_tpu/kernels/fir.py``).

The JAX package folds the taps into (S, K*S) matmul plans because XLA's
small-channel convolution is slow on the TPU.  On the card the bank is
what it computes: a VALID cross-correlation, one ``conv1d`` with the
bank's K filters as output channels, in full fp32.

y[..., k, t] = sum_m h[k, m] * x[..., t + m]   (cross-correlation,
"valid": t in [0, T), T = x.shape[-1] - taps + 1).  Callers pre-pad x
for whatever alignment they need.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import full_precision


@full_precision
def fir_correlate(x: torch.Tensor, h) -> torch.Tensor:
    """Apply a static (K, taps) FIR bank: (..., Tp) -> (..., K, Tp-taps+1).

    ``h`` is a numpy array or a tensor; it is taken in ``x``'s dtype and
    device.
    """
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    K, taps = h.shape
    T = x.shape[-1] - taps + 1
    if T <= 0:
        raise ValueError("signal shorter than the filter")
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), h[:, None, :])
    return y.reshape(x.shape[:-1] + (K, T))
