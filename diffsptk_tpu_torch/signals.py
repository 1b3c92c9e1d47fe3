"""Test-signal generators (counterpart of ``diffsptk_tpu/signals.py``):
the maximum-length sequence that ``ExcitationGeneration`` takes for its
unvoiced region."""

from __future__ import annotations

import math

import numpy as np
import torch

from .core import resolve_device


def mseq(*order, dtype=None, device=None) -> torch.Tensor:
    """Maximum-length sequence in {-1, +1} of shape ``order`` with the last
    dimension one longer, via the SPTK 32-bit LFSR (taps at bits 0 and
    28).  The register steps once per sample in a host loop (about a
    second per million samples), then the sequence moves to ``device``
    (the card unless ``device="cpu"``)."""
    if len(order) == 1 and isinstance(order[0], (list, tuple)):
        shape = list(order[0])
    else:
        shape = list(order)
    shape[-1] += 1
    n = math.prod(shape)
    out = np.ones(n)
    x = 0x55555555
    for i in range(n):
        x >>= 1
        x0 = 1 if x & 0x00000001 else -1
        x28 = 1 if x & 0x10000000 else -1
        if x0 + x28:
            x &= 0x7FFFFFFF
        else:
            x |= 0x80000000
        if x0 != 1:
            out[i] = x0
    return torch.as_tensor(out.reshape(shape),
                           dtype=dtype or torch.get_default_dtype(),
                           device=resolve_device(device))


def mseq_like(x: torch.Tensor, dtype=None) -> torch.Tensor:
    shape = list(x.shape)
    shape[-1] -= 1
    return mseq(*shape, dtype=dtype or x.dtype, device=x.device)
