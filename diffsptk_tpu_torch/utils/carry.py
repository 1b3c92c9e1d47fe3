"""Carry parameters of a JAX-package object into its port counterpart.

``params`` is a flat dict of numpy arrays named by the JAX object's
attribute path -- for example ``"mlsa.mglsadf.a"`` and
``"imlsa.mglsadf.mglsadf.a"`` for the Taylor weights of a
``MelCepstralVocoder``, ``"stft.spec.fftr.W"`` for a learnable DFT,
``"fbank.H"`` for the filterbank weights of an ``MFCC`` or ``PLP`` built
with ``learnable=True`` (``"H"`` of an ``FBANK`` or ``IFBANK``), or
``"params"`` for a learnable ``DRC``.  The port module keeps the same
paths for its parameters and buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def load_jax_params(module: nn.Module, params: dict) -> None:
    """Copy ``params`` into ``module``'s parameters and buffers.

    Raises ``KeyError`` for a name the module does not have or a learnable
    parameter of the module that ``params`` does not give, and
    ``ValueError`` for a shape mismatch.  Values keep the module's dtype
    and device.
    """
    targets = dict(module.named_parameters())
    learnable = set(targets)
    targets.update(dict(module.named_buffers()))
    extra = sorted(set(params) - set(targets))
    if extra:
        raise KeyError(f"names not in the module: {extra}")
    missing = sorted(learnable - set(params))
    if missing:
        raise KeyError(f"learnable parameters not given: {missing}")
    for name, value in params.items():
        target = targets[name]
        value = np.asarray(value)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{name}: shape {tuple(value.shape)} does not match "
                f"{tuple(target.shape)}")
    with torch.no_grad():
        for name, value in params.items():
            target = targets[name]
            target.copy_(torch.as_tensor(np.asarray(value),
                                         dtype=target.dtype))
