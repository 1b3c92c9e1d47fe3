"""A torch copy of JAX's default random number generator.

JAX's default PRNG is the counter-based Threefry-2x32 hash (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011) with JAX's
"partitionable" layout (``jax_threefry_partitionable``, on by default since
jax 0.5): element i of a draw hashes the 64-bit counter (hi, lo) of its flat
index, so every element depends only on its key and its own index.  This
module reproduces JAX's bits exactly and its floats to rounding: the WORLD
ops of the port draw the same noise as the JAX package's from the same key.

A key is an int64 tensor of shape (..., 2) holding two 32-bit words; leading
dimensions are a batch of keys, as JAX's keys under ``vmap``.  Every word is
kept in int64 with explicit masks (torch has no full uint32 arithmetic), so
nothing here needs an unsigned type.  The functions mirror jax 0.9.0:

* ``PRNGKey``  -- ``prng.py:threefry_seed``: (seed >> 32, seed & 0xFFFFFFFF);
* ``fold_in``  -- ``prng.py:_threefry_fold_in``: the hash of the counter
  (0, data) under the key;
* ``split``    -- ``prng.py:_threefry_split_foldlike``: key i is the hash
  of the counter (hi(i), lo(i));
* ``bits``     -- ``prng.py:_threefry_random_bits_partitionable``: 32-bit
  bits are bits1 ^ bits2, 64-bit bits bits1 << 32 | bits2;
* ``uniform``  -- ``random.py:_uniform``: the top mantissa bits under an
  exponent of 0, minus 1, scaled to [minval, maxval);
* ``normal``   -- ``random.py:_normal_real``: sqrt(2) erfinv(u), u uniform
  on [nextafter(-1, 0), 1).  At float32 erfinv is the single-precision
  polynomial of M. Giles ("Approximating the erfinv function", GPU
  Computing Gems, 2011) that XLA lowers ``erf_inv`` to, so the port's
  float32 normals agree with JAX's to an ulp or two; at float64 it is
  ``torch.special.erfinv``.

The hand-written CUDA kernel (``kernels/threefry.py``) draws float32
normals on the card; this module is its plain twin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Giles' single-precision erfinv (XLA's ErfInv32): a degree-8 polynomial in
# w - 2.5 where w = -log1p(-x^2) < 5, else in sqrt(w) - 3.
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counters (x1, x2) under
    the key (k1, k2): int64 tensors of 32-bit words, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """The key of an integer seed, as ``jax.random.PRNGKey`` makes it from
    a 64-bit seed: (seed >> 32, seed & 0xFFFFFFFF).  Filled on ``device``:
    a key built from a host list would be copied to the card and waited
    for."""
    seed = int(seed)
    return torch.stack([torch.full((), word, dtype=torch.int64,
                                   device=device)
                        for word in ((seed >> 32) & MASK, seed & MASK)])


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if key.shape[-1:] != (2,) or key.dtype != torch.int64:
        raise TypeError(
            f"a key is an int64 tensor of shape (..., 2); got {key.dtype} "
            f"{tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` and integer ``data``
    (taken mod 2^32, as JAX casts it to uint32).  ``data`` may be a tensor;
    the key broadcasts against it and the result has shape
    broadcast(key.shape[:-1], data.shape) + (2,)."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key into ``num`` keys, (num, 2)."""
    k1, k2 = _words(key)
    hi, lo = _counters(num, key.device)
    y1, y2 = threefry2x32(k1[..., None], k2[..., None], hi, lo)
    return torch.stack((y1, y2), dim=-1)


def _hash_shape(key: torch.Tensor, shape) -> tuple:
    """bits1, bits2 of every element of ``shape`` under each key, shaped
    key.shape[:-1] + shape."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    hi, lo = _counters(math.prod(shape), key.device)
    batch = k1.shape
    k1 = k1.reshape(batch + (1,))
    k2 = k2.reshape(batch + (1,))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1.reshape(batch + shape), b2.reshape(batch + shape)


def bits(key: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: 32-bit words as int64 values in [0, 2^32), or
    64-bit words as int64 tensors holding the uint64 bit pattern."""
    b1, b2 = _hash_shape(key, shape)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"width must be 32 or 64, not {width}")


def unit32(bits32: torch.Tensor) -> torch.Tensor:
    """float32 uniform on [0, 1) from 32-bit draws (int64 values in
    [0, 2^32)): their top 23 bits over 2^23, exact (JAX sets them under an
    exponent of 0 and subtracts 1)."""
    return (bits32 >> 9).to(torch.float32) * 2.0 ** -23


def _unit(key: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Uniform on [0, 1): the top mantissa bits of the draw over 2^nmant."""
    b1, b2 = _hash_shape(key, shape)
    if dtype == torch.float32:
        return unit32(b1 ^ b2)
    if dtype == torch.float64:
        # the top 52 of bits1 << 32 | bits2, built without uint64
        return ((b1 << 20) | (b2 >> 12)).to(dtype) * 2.0 ** -52
    raise TypeError(f"uniform takes float32 or float64, not {dtype}")


def to_range(unit: torch.Tensor, dtype, minval: float = 0.0,
             maxval: float = 1.0) -> torch.Tensor:
    """Uniform values on [0, 1) scaled to [minval, maxval) as
    ``jax.random.uniform`` scales them.  The bounds and their span are
    rounded to ``dtype`` on the host, as JAX computes them in it; no
    scalar is copied to the device."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = np_dtype(minval), np_dtype(maxval)
    return torch.clamp(unit * float(hi - lo) + float(lo), min=float(lo))


def uniform(key: torch.Tensor, shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval)."""
    return to_range(_unit(key, shape, dtype), dtype, minval, maxval)


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it (Giles' polynomial), for |x| < 1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(small, torch.full_like(x, ERFINV_SMALL[i]),
                           ERFINV_LARGE[i])

    p = coeff(0)
    for i in range(1, len(ERFINV_SMALL)):
        p = coeff(i) + p * w
    return p * x


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1), np_dtype(0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    erfinv = erfinv_giles if dtype == torch.float32 else torch.special.erfinv
    return float(np_dtype(np.sqrt(2))) * erfinv(u)


def slot_counters(time_index: torch.Tensor, span: int,
                  batch_offset: int = 0) -> torch.Tensor:
    """The fold-in data of WORLD's per-slot noise: (b + batch_offset) *
    span + time_index[b, p], in int32 arithmetic as JAX computes it (so
    taken mod 2^32)."""
    B = time_index.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=time_index.device)
    return ((rows[:, None] + batch_offset) * span
            + time_index.to(torch.int64)) & MASK


def slot_normal(seed: int, time_index: torch.Tensor, span: int,
                batch_offset: int, length: int, dtype) -> torch.Tensor:
    """WORLD synthesis' per-slot noise (B, P, length): slot (b, p) draws
    ``normal(fold_in(PRNGKey(seed), ctr), (length,))`` with ``ctr`` from
    :func:`slot_counters`, the JAX package's counter-keyed stream."""
    keys = fold_in(PRNGKey(seed, time_index.device),
                   slot_counters(time_index, span, batch_offset))
    return normal(keys, (length,), dtype)
