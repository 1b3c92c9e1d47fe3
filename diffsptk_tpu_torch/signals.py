"""Test-signal generators (counterpart of ``diffsptk_tpu/signals.py``).

Every generator makes a sequence of length M+1 (or shape (..., M+1)) on
the card unless the caller passes ``device="cpu"``.  The random ones draw
from JAX's generator (``utils/prng.py``) under an explicit ``key``; without
one, the n-th call in a process draws from the n-th key of the JAX
package's own counter (a ``SeedSequence(0)`` spawning one child a call),
so it draws what the JAX package's n-th call draws.  They draw on the
device (``kernels/threefry.py``: the threefry kernel for a float32 draw
on the card).

Examples
--------
>>> import diffsptk_tpu_torch as pt
>>> pt.ramp(4, device="cpu").tolist()
[0.0, 1.0, 2.0, 3.0, 4.0]
>>> pt.train(5, 2, norm="none", device="cpu").tolist()
[1.0, 0.0, 1.0, 0.0, 1.0, 0.0]
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .core import resolve_device
from .kernels import threefry
from .utils import prng


class _KeyCounter:
    """The JAX package's ``_auto_key``: one child of ``SeedSequence(0)``
    per call, its first word the seed of the key."""

    def __init__(self) -> None:
        self._seq = np.random.SeedSequence(0)
        self._lock = threading.Lock()

    def next_key(self) -> torch.Tensor:
        with self._lock:
            child = self._seq.spawn(1)[0]
        return prng.PRNGKey(int(child.generate_state(1)[0]))


_KEYS = _KeyCounter()


def _shape(order) -> list:
    if len(order) == 1 and isinstance(order[0], (list, tuple)):
        shape = list(order[0])
    else:
        shape = list(order)
    shape[-1] += 1
    return shape


def _host_key(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(key) if not isinstance(
        key, torch.Tensor) else key, dtype=torch.int64, device="cpu")


def _place(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype or torch.get_default_dtype(),
                           device=resolve_device(device))


def impulse(order: int, dtype=None, device=None) -> torch.Tensor:
    """Unit impulse of length M+1."""
    x = np.zeros(order + 1)
    x[0] = 1
    return _place(x, dtype, device)


def step(order: int, value: float = 1, dtype=None,
         device=None) -> torch.Tensor:
    """Constant (step) sequence of length M+1."""
    return _place(np.full(order + 1, float(value)), dtype, device)


def ramp(arg, end=None, step: float = 1, *, eps: float = 1e-8, dtype=None,
         device=None) -> torch.Tensor:
    """SPTK's ramp: with ``arg`` alone, 0 to ``arg`` inclusive; otherwise
    ``arg`` to ``end`` inclusive in steps of ``step``."""
    if end is None:
        start, stop = 0.0, float(arg)
    else:
        start, stop = float(arg), float(end)
    n = int(np.floor((stop - start) / step + eps)) + 1
    return _place(start + step * np.arange(max(n, 0)), dtype, device)


def sin(order: int, period: float | None = None, magnitude: float = 1,
        dtype=None, device=None) -> torch.Tensor:
    """Sinusoid of length M+1 with the given period in samples."""
    if period is None:
        period = order + 1
    n = torch.arange(order + 1, dtype=dtype or torch.get_default_dtype(),
                     device=resolve_device(device))
    return torch.sin(n * (2 * math.pi / period)) * magnitude


def train(order: int, frame_period: float, norm: str | int = "power",
          dtype=None, device=None) -> torch.Tensor:
    """Pulse train of length M+1 with a pulse every ``frame_period``
    samples, of height 1, sqrt(P) or P for ``norm`` none, power or
    magnitude."""
    if frame_period < 1:
        raise ValueError("frame_period must be greater than or equal to 1.")
    if norm in (0, "none"):
        pulse = 1.0
    elif norm in (1, "power"):
        pulse = frame_period ** 0.5
    elif norm in (2, "magnitude"):
        pulse = float(frame_period)
    else:
        raise ValueError(f"norm {norm} is not supported.")
    # a pulse where the floor of the accumulated frequency steps up
    f = 1.0 / frame_period
    v = np.full(order + 2, f)
    v[0] = -f
    v = np.floor(np.cumsum(v))
    x = np.zeros(order + 1)
    x[np.diff(v) >= 1] = pulse
    return _place(x, dtype, device)


def mseq(*order, dtype=None, device=None) -> torch.Tensor:
    """Maximum-length sequence in {-1, +1} of shape ``order`` with the last
    dimension one longer, via the SPTK 32-bit LFSR (taps at bits 0 and
    28).  The register steps once per sample in a host loop (about a
    second per million samples), then the sequence moves to ``device``
    (the card unless ``device="cpu"``)."""
    shape = _shape(order)
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


def nrand(*order, key=None, mean: float = 0, stdv: float = 1,
          var: float | None = None, dtype=None,
          device=None) -> torch.Tensor:
    """Gaussian noise of shape (..., M+1): ``jax.random.normal`` of
    ``key``, drawn on ``device``."""
    shape = _shape(order)
    if var is not None:
        stdv = var ** 0.5
    if key is None:
        key = _KEYS.next_key()
    x = threefry.normal(_host_key(key), tuple(shape),
                        dtype or torch.get_default_dtype(),
                        resolve_device(device))
    return x * stdv + mean


def nrand_like(x: torch.Tensor, **kwargs) -> torch.Tensor:
    shape = list(x.shape)
    shape[-1] -= 1
    kwargs.setdefault("device", x.device)
    return nrand(*shape, dtype=kwargs.pop("dtype", x.dtype), **kwargs)


def rand(*order, key=None, a: float = 0, b: float = 1, dtype=None,
         device=None) -> torch.Tensor:
    """Uniform noise in [a, b) of shape (..., M+1): ``jax.random.uniform``
    of ``key``, drawn on ``device``."""
    shape = _shape(order)
    if key is None:
        key = _KEYS.next_key()
    return threefry.uniform(_host_key(key), tuple(shape),
                            dtype or torch.get_default_dtype(),
                            resolve_device(device), minval=a, maxval=b)


def rand_like(x: torch.Tensor, **kwargs) -> torch.Tensor:
    shape = list(x.shape)
    shape[-1] -= 1
    kwargs.setdefault("device", x.device)
    return rand(*shape, dtype=kwargs.pop("dtype", x.dtype), **kwargs)
