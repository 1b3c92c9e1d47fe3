"""Checkpointing of learned state (counterpart of
``diffsptk_tpu/utils/checkpoint.py``), npz only.

A tree of tensors (dicts, lists and tuples of tensors, e.g. a learner's
parameters) is saved as its leaves ``"0"``, ``"1"``, ... in JAX's order
of flattening: a dict's keys sorted, lists and tuples in order.  The JAX
package's ``load`` reads the leaves by that order and ignores
``__treedef__``, so a file written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

_BACKENDS = ("auto", "orbax", "npz")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend} is not supported.")
    if backend == "orbax":
        raise ValueError(
            "the PyTorch port has no orbax backend; use backend='npz'")


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
    return leaf


def _path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree, backend: str = "auto") -> None:
    """Save a tree of tensors or arrays to the file ``path`` (``.npz``)."""
    _check_backend(backend)
    leaves = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
              else np.asarray(a) for a in _flatten(tree)]
    np.savez(_path(path),
             __treedef__=np.frombuffer(repr(type(tree)).encode(),
                                       dtype=np.uint8),
             **{str(i): a for i, a in enumerate(leaves)})


def load(path: str, like, backend: str = "auto"):
    """Load a checkpoint saved by :func:`save` (in either package) into
    the structure of ``like``; tensor leaves take the dtype and device of
    ``like``'s."""
    _check_backend(backend)
    with np.load(_path(path)) as data:
        n = len(_flatten(like))
        leaves = iter([data[str(i)] for i in range(n)])
        return _unflatten(like, leaves)
