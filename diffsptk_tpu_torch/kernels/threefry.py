"""JAX's random numbers on the card: hand-written CUDA kernel
(``csrc/threefry.cu``) and the dispatch between it and its plain twin,
``utils/prng.py``.

Four draws: :func:`normal`, :func:`uniform` and :func:`randint`, flat
draws under one key (WORLD's dither in ``ops/world_common.py``, excitation
noise, the learners' initial codebooks and factors, ``signals.nrand`` and
``rand``, the pitch trainer's device corpus), and :func:`slot_normal`,
WORLD's synthesis noise under keys folded from each slot's counter
(``ops/world_synth.py``).  A CUDA float32 (or int32) draw launches the
kernel; a CPU tensor, float64, or a draw inside ``twins()`` takes the
twin.  Both give JAX's bits, float32 uniform values and float32 normals
bit for bit: each copies XLA CPU's float32 log1p and fuses the
multiply-adds XLA fuses.  A float32 uniform draw is one launch of the
kernel's uniform entry; randint's two draws of 32-bit words are two
launches of its bits entry, combined by the twin's arithmetic.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import prng
from ..utils.profiling import span
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
    uni = lib.threefry_uniform
    uni.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                    ctypes.c_void_p]
    uni.restype = ctypes.c_int
    return flat, slot, uni


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


@span("kernel.threefry.normal")
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


@span("kernel.threefry.uniform")
def uniform_cuda(key: torch.Tensor, shape, device, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """``prng.uniform(key, shape, float32, minval, maxval)`` on the card, in
    one launch: the bounds and their span rounded to float32 on the host,
    the scale and shift one fused multiply-add, as the twin's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("uniform_cuda draws on a CUDA device")
    out = torch.empty(tuple(int(s) for s in shape), device=device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lo, hi = np.float32(minval), np.float32(maxval)
    k0, k1 = _key_words(key)
    _launch(_lib()[2], k0, k1, out.data_ptr(), out.numel(), float(lo),
            float(hi - lo), device=device)
    return out


@span("kernel.threefry.slot_normal")
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
    ``device``: the kernel for a CUDA float32 draw (the twin's values bit
    for bit), the twin elsewhere."""
    if _use_kernel(device, dtype):
        return uniform_cuda(key, shape, device, minval, maxval)
    return prng.uniform(_on(key, device), shape, dtype, minval, maxval)


def randint(key: torch.Tensor, shape, minval: int, maxval: int, dtype,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` on
    ``device``: for a CUDA int32 draw the kernel's bits under each half of
    the key (two launches), combined as the twin combines them (the same
    values); the twin elsewhere (an int64 draw takes 64-bit words, which
    the kernel does not make)."""
    if (torch.device(device).type == "cuda" and dtype == torch.int32
            and not use_twins()):
        k1, k2 = prng.split(key, 2)
        words = [normal_cuda(k, shape, device, bits=True).to(torch.int64)
                 & prng.MASK for k in (k1, k2)]
        return prng.randint_from_bits(*words, minval, maxval, dtype)
    return prng.randint(_on(key, device), shape, minval, maxval, dtype)


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

