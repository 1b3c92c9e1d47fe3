"""JAX's random normals on the card: hand-written CUDA kernel
(``csrc/threefry.cu``) and the dispatch between it and its plain twin,
``utils/prng.py``.

Three draws: :func:`normal` and :func:`uniform`, flat draws under one
key (WORLD's dither in ``ops/world_common.py``, excitation noise, the
learners' initial codebooks and factors, ``signals.nrand`` and ``rand``),
and :func:`slot_normal`, WORLD's synthesis noise under keys folded from
each slot's counter (``ops/world_synth.py``).  A CUDA float32 draw launches
the kernel; a CPU tensor, float64, or a draw inside ``twins()`` takes the
twin.  Both give JAX's bits exactly, and float32 normals within an ulp or
two of each other (the kernel's Horner steps fuse their multiply-adds).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import prng
from . import build
from .state import use_twins

launches = 0
"""Number of kernel launches so far (the twin does not count)."""


@functools.cache
def _lib():
    lib = build.library("threefry")
    flat = lib.threefry_flat
    flat.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    flat.restype = ctypes.c_int
    slot = lib.threefry_slot
    slot.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_void_p]
    slot.restype = ctypes.c_int
    return flat, slot


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two words of one key (a host read where the key lies on the
    card; WORLD's keys are made on the host)."""
    if key.shape != (2,) or key.dtype != torch.int64:
        raise TypeError(
            f"the kernel takes one int64 key of shape (2,); got {key.dtype} "
            f"{tuple(key.shape)}")
    k0, k1 = key.tolist()
    return k0 & prng.MASK, k1 & prng.MASK


def _launch(fn, *args, device) -> None:
    global launches
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    build.check(err, fn.__name__)
    launches += 1


def normal_cuda(key: torch.Tensor, shape, device, bits: bool = False
                ) -> torch.Tensor:
    """``prng.normal(key, shape, float32)`` on the card (``bits=True``:
    ``prng.bits(key, shape)`` as int32 bit patterns)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("normal_cuda draws on a CUDA device")
    shape = tuple(int(s) for s in shape)
    out = torch.empty(shape, device=device,
                      dtype=torch.int32 if bits else torch.float32)
    if out.numel() == 0:
        return out
    k0, k1 = _key_words(key)
    _launch(_lib()[0], k0, k1, out.data_ptr(), out.numel(), int(bits),
            device=device)
    return out


def slot_normal_cuda(seed: int, time_index: torch.Tensor, span: int,
                     batch_offset: int, length: int, bits: bool = False
                     ) -> torch.Tensor:
    """``prng.slot_normal(...)`` at float32 on the card: time_index (B, P)
    integer on a CUDA device -> (B, P, length) (``bits=True``: the bits of
    each slot's draw, as int32 bit patterns)."""
    if not time_index.is_cuda or time_index.ndim != 2:
        raise ValueError("slot_normal_cuda takes a (B, P) CUDA time_index")
    B, P = time_index.shape
    out = torch.empty((B, P, int(length)), device=time_index.device,
                      dtype=torch.int32 if bits else torch.float32)
    if out.numel() == 0:
        return out
    k0, k1 = _key_words(prng.PRNGKey(seed))
    ti = time_index.to(torch.int64).contiguous()
    _launch(_lib()[1], k0, k1, ti.data_ptr(), out.data_ptr(), B, P,
            int(length), int(span), int(batch_offset), int(bits),
            device=time_index.device)
    return out


def _use_kernel(device, dtype) -> bool:
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and not use_twins())


def _on(key: torch.Tensor, device) -> torch.Tensor:
    """The key on ``device``: a host key bound for the card is filled
    there from its words, as a copy of it would wait for the card."""
    if torch.device(device).type != "cuda" or key.is_cuda:
        return key.to(device)
    return torch.stack([torch.full((), w, dtype=torch.int64, device=device)
                        for w in key.tolist()])


def normal(key: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` on ``device``: the kernel
    for a CUDA float32 draw, the twin elsewhere."""
    if _use_kernel(device, dtype):
        return normal_cuda(key, shape, device)
    return prng.normal(_on(key, device), shape, dtype)


def uniform(key: torch.Tensor, shape, dtype, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` on
    ``device``: for a CUDA float32 draw the kernel's bits, scaled as the
    twin scales them (the same values bit for bit), the twin elsewhere."""
    if _use_kernel(device, dtype):
        b = normal_cuda(key, shape, device, bits=True).to(torch.int64)
        return prng.to_range(prng.unit32(b & prng.MASK), dtype, minval,
                             maxval)
    return prng.uniform(_on(key, device), shape, dtype, minval, maxval)


def slot_normal(seed: int, time_index: torch.Tensor, span: int,
                batch_offset: int, length: int, dtype) -> torch.Tensor:
    """WORLD's per-slot noise (B, P, length) on time_index's device: the
    kernel for a CUDA float32 draw, the twin elsewhere."""
    if _use_kernel(time_index.device, dtype):
        return slot_normal_cuda(seed, time_index, span, batch_offset, length)
    return prng.slot_normal(seed, time_index, span, batch_offset, length,
                            dtype)


def operations(n_values: int, n_keys: int = 0) -> float:
    """Integer and float operations of a draw of ``n_values`` normals under
    ``n_keys`` folded keys: one hash each (2 + 5 x (4 x 3 + 3) = 77
    operations), and per value the xor, the float conversion and u (5) and
    Giles' erfinv with the scale by sqrt(2) (about 25)."""
    return 77.0 * (n_values + n_keys) + 30.0 * n_values

