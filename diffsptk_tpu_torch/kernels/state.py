"""Explicit request to run the kernels' plain twins on the card.

A kernel wrapper takes its plain twin for a CPU tensor.  For a CUDA tensor
it launches its kernel, unless the caller asked for the twins inside
``with twins():`` -- the way a comparison run drives the same chain
through the plain versions on the same card.  Nothing falls back to a twin
on its own.
"""

from __future__ import annotations

import contextlib
import contextvars

_TWINS = contextvars.ContextVar("diffsptk_tpu_torch_twins", default=False)


def use_twins() -> bool:
    return _TWINS.get()


@contextlib.contextmanager
def twins():
    """Within this block every kernel wrapper runs its plain twin."""
    token = _TWINS.set(True)
    try:
        yield
    finally:
        _TWINS.reset(token)
