"""Core module protocol of the PyTorch/CUDA port.

Every operator keeps the split of the JAX package:

* ``_check(...)``  -- host-side parameter validation (raises ``ValueError``);
* ``_design(...)`` -- host-side construction of all derived state, returning
  a :class:`Design` of scalar ``values``, child ``layers`` and numpy
  ``arrays``.  Design math runs in numpy float64 whatever the compute dtype;
* ``_forward(x, **state)`` -- plain torch.

An operator is an ``nn.Module``: design arrays become buffers, or
``nn.Parameter``s where the op is learnable, so ``.to()``, ``state_dict``
and ``torch.optim`` work with no further plumbing.

Operators run on the card unless the caller passes ``device="cpu"``:
``device=None`` means ``"cuda"`` and raises where there is no card.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def full_precision(fn):
    """Run ``fn`` with every float32 matmul and convolution in full fp32.

    The library assembles solver systems and basis transforms by matmul
    (Newton Hessians, freqt warps, DFT plans); TF32 rounding there breaks
    float32 parity.  The flags are set inside the library's entry points
    and restored on exit, never changed for the rest of the process.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    return wrapper


class Design(NamedTuple):
    """Host-side precomputed state for one operator.

    values:  static Python scalars / strings / callables.
    layers:  child operators.
    arrays:  numpy constants that become buffers (or parameters).
    """

    values: dict[str, Any] = {}
    layers: dict[str, Any] = {}
    arrays: dict[str, Any] = {}


def filter_values(d: dict, drop_keys: tuple = ()) -> dict:
    """Forward constructor locals to ``_design`` without re-listing them."""
    drop = ("self", "__class__", "device", "dtype") + tuple(drop_keys)
    return {k: v for k, v in d.items() if k not in drop}


def check_size(actual: int, expected: int, name: str) -> None:
    if actual != expected:
        raise ValueError(
            f"Unexpected {name} (input {actual} vs expected {expected}).")


def child(cls, **kwargs):
    """Build a child operator on the host in float64; the parent's
    ``_setup`` moves the whole tree to its device and dtype."""
    return cls(**kwargs, device="cpu", dtype=torch.float64)


def place(module: nn.Module, device=None, dtype=None) -> nn.Module:
    """Move a freshly built module tree to ``device`` (default: the card)
    in ``dtype`` (default: torch's default dtype); complex buffers take
    the complex counterpart of ``dtype``."""
    dev = resolve_device(device)
    dt = dtype or torch.get_default_dtype()
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128

    def convert(t):
        if t.is_complex():
            return t.to(device=dev, dtype=cdt)
        if t.is_floating_point():
            return t.to(device=dev, dtype=dt)
        return t.to(device=dev)

    return module._apply(convert)


class BaseOp(nn.Module):
    """Base class of the port's operators.

    Subclasses implement ``_check``, ``_design`` and ``_forward``; the
    constructor calls ``_setup``.  ``learnable=True`` (or a list of array
    names) turns those design arrays into ``nn.Parameter``s.  A subclass
    that overrides ``forward`` (to check input sizes) calls this class's
    ``forward``, which runs every matmul in full fp32.
    """

    def _setup(self, design: Design, learnable: bool | list[str] = False,
               dtype=None, device=None) -> None:
        self._value_names = tuple(design.values)
        for name, value in design.values.items():
            setattr(self, name, value)
        self._layer_names = tuple(design.layers)
        for name, layer in design.layers.items():
            setattr(self, name, layer)
        if learnable is True:
            learn = tuple(design.arrays)
        elif learnable is False:
            learn = ()
        else:
            learn = tuple(learnable)
        self._array_names = tuple(design.arrays)
        for name, a in design.arrays.items():
            a = np.asarray(a)
            t = torch.as_tensor(a.astype(
                np.complex128 if np.iscomplexobj(a) else np.float64))
            if name in learn:
                self.register_parameter(name, nn.Parameter(t))
            else:
                self.register_buffer(name, t)
        place(self, device, dtype)

    def _state(self) -> dict:
        names = self._value_names + self._layer_names + self._array_names
        return {name: getattr(self, name) for name in names}

    @full_precision
    def forward(self, *args, **kwargs):
        return self._forward(*args, **kwargs, **self._state())

    @staticmethod
    def _check(*args, **kwargs) -> None:
        raise NotImplementedError

    @staticmethod
    def _design(*args, **kwargs) -> Design:
        raise NotImplementedError

    @staticmethod
    def _forward(*args, **kwargs):
        raise NotImplementedError


class BaseNonFunctionalOp(BaseOp):
    """Marker: an operator with no stateless functional form (the JAX
    package's ``BaseNonFunctionalOp``, ``diffsptk_tpu/core.py:221``)."""
