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
* ``randint``  -- ``random.py:_randint``: two draws of words under the
  halves of the key, combined modulo the span;
* ``normal``   -- ``random.py:_normal_real``: sqrt(2) erfinv(u), u uniform
  on [nextafter(-1, 0), 1).  At float32 erfinv is the single-precision
  polynomial of M. Giles ("Approximating the erfinv function", GPU
  Computing Gems, 2011) that XLA lowers ``erf_inv`` to, with the
  logarithm XLA's CPU backend inlines for ``log1p`` (:func:`log1p_xla`)
  and the multiply-adds it fuses, so the port's float32 normals equal
  JAX's bit for bit; at float64 it is ``torch.special.erfinv``, within
  rtol 1e-10 (XLA calls the C library's ``log`` there).

The hand-written CUDA kernel (``kernels/threefry.py``) draws float32
normals on the card; this module is its plain twin.
"""

from __future__ import annotations

import functools
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

# XLA CPU's float32 log1p (``xla.log1p.f32``, jax 0.9.0), read off its
# optimised LLVM IR and machine code.  Below |x| < sqrt(2) - 1 it is the
# rational x - x^2/2 + x^3 P(x)/Q(x); above, Cephes' logf of 1 + x: the
# mantissa m in [sqrt(1/2), sqrt(2)) - 1, three interleaved quadratics
# joined in x^3, and the exponent times ln 2 in two parts.  The backend
# fuses each multiply that feeds one add; ``fma32`` does the same.
LOG1P_SMALL = 0.4142135679721832             # float32(sqrt(2) - 1)
LOG1P_DEN = (15.062909126281738, 83.04756927490234, 221.7624053955078,
             309.0987243652344, 216.42788696289062, 60.11865997314453)
LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
             29.91191864013672, 60.949668884277344, 57.11296463012695,
             20.039552688598633)
LOGF_SQRTH = 0.7071067690849304              # float32(sqrt(1/2))
LOGF_QUADRATICS = (
    (0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
    (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
    (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
LN2_LO = -0.00021219444170128554
LN2_HI = 0.693359375


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
    scalar is copied to the device.  At float32 the scale and shift are
    one fused multiply-add, as XLA's CPU backend fuses them, so the values
    equal JAX's bit for bit; at float64 they are rounded twice (within an
    ulp of JAX's)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = np_dtype(minval), np_dtype(maxval)
    if dtype == torch.float32:
        scaled = fma32(unit, float(hi - lo), float(lo))
    else:
        scaled = unit * float(hi - lo) + float(lo)
    return torch.clamp(scaled, min=float(lo))


def uniform(key: torch.Tensor, shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval)."""
    return to_range(_unit(key, shape, dtype), dtype, minval, maxval)


_INT_BITS = {torch.int32: 32, torch.int64: 64}


def _urem(x: torch.Tensor, span: int, nbits: int) -> torch.Tensor:
    """x mod span for unsigned ``nbits``-bit words ``x`` (32-bit words as
    int64 values in [0, 2^32); 64-bit words as int64 bit patterns) and a
    span in [1, 2^nbits)."""
    if nbits == 32 or span == 1:
        return torch.remainder(x, span)
    top = 1 << 63
    if span >= top:                     # one subtraction at most
        big = (x ^ -top) >= ((span - (1 << 64)) ^ -top)   # unsigned >=
        return torch.where(big, x - span, x)
    low = torch.remainder(x & (top - 1), span)
    high = top % span                   # the top bit's share of x mod span
    wrap = torch.where(low >= span - high, low - (span - high), low + high)
    return torch.where(x < 0, wrap, low)


def _mul_wrap32(a: torch.Tensor, m: int) -> torch.Tensor:
    """a * m mod 2^32 for a in [0, 2^32) and m < 2^32, in int64 without
    overflow (16 bits of m at a time)."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      minval: int, maxval: int, dtype) -> torch.Tensor:
    """``jax.random.randint``'s arithmetic (``random.py:_randint``) on its
    two draws of ``nbits``-bit words, as :func:`bits` returns them.

    The bounds are clipped to ``dtype``'s range and the span is taken
    modulo 2^nbits, as JAX does; the span is 1 where maxval <= minval and
    one more where maxval lies above the type's maximum.  The offset is
    (higher mod span) * m + lower mod span with m = (2^(nbits/2) mod
    span)^2 mod span, every product and sum wrapping in ``nbits`` bits as
    JAX's unsigned words do, then mod span (a span of 0 -- the whole range -- keeps
    ``lower``, as XLA's remainder by zero does)."""
    nbits = _INT_BITS[dtype]
    full = (1 << nbits) - 1
    info = torch.iinfo(dtype)
    minval, maxval = int(minval), int(maxval)
    lo = min(max(minval, info.min), info.max)
    hi = min(max(maxval, info.min), info.max)
    span = (hi - lo) & full
    if hi <= lo:
        span = 1
    elif maxval > info.max:
        span = (span + 1) & full
    if span == 0:
        offset = lower
    else:
        half = (1 << (nbits // 2)) % span
        mult = ((half * half) & full) % span   # the square wraps too
        a = _urem(higher, span, nbits)
        b = _urem(lower, span, nbits)
        if nbits == 32:
            offset = _urem((_mul_wrap32(a, mult) + b) & MASK, span, 32)
        else:
            # int64 products and sums wrap modulo 2^64 as uint64's do
            offset = _urem(a * mult + b, span, 64)
    if nbits == 32:
        word = (offset + lo) & MASK
        return torch.where(word >= 1 << 31, word - (1 << 32), word).to(dtype)
    return offset + lo


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint`` on [minval, maxval) (integer bounds): the key
    split in two, one draw of ``nbits``-bit words under each (32 for int32,
    64 for int64, JAX's default integer under x64), combined by
    :func:`randint_from_bits`."""
    if dtype not in _INT_BITS:
        raise TypeError(f"randint takes int32 or int64, not {dtype}")
    nbits = _INT_BITS[dtype]
    k1, k2 = split(key, 2)
    return randint_from_bits(bits(k1, shape, nbits), bits(k2, shape, nbits),
                             minval, maxval, dtype)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add rounds it.

    The product of two float32 values is exact in float64; the sum is
    taken there with its rounding error (Knuth's two-sum), and an inexact
    sum is rounded to odd, which makes its rounding to float32 the
    correct one (Boldo and Melquiond, "Emulation of FMA and correctly
    rounded sums", IEEE TC 57(4), 2008)."""
    f64 = torch.float64
    # a Python scalar stays one: a device tensor made from it would be a
    # copy from the host
    b = b.to(f64) if torch.is_tensor(b) else float(b)
    c = c.to(f64) if torch.is_tensor(c) else float(c)
    p = a.to(f64) * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    word = s.view(torch.int64)
    step = torch.where((s > 0) == (err > 0), 1, -1)
    word = word + torch.where((err != 0) & ((word & 1) == 0), step, 0)
    return word.view(f64).to(torch.float32)


def sqrt32(w: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's ``sqrt`` is.

    torch's CPU square root may be an ulp off (it can reach a vector math
    library), so the float64 root rounded to float32 is checked against
    the two midpoints beside it, whose squares are exact in float64."""
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    up = torch.nextafter(root, torch.full_like(root, math.inf))
    down = torch.nextafter(root, torch.zeros_like(root))
    r64, w64 = root.to(torch.float64), w.to(torch.float64)
    hi = (r64 + up.to(torch.float64)) * 0.5
    lo = (r64 + down.to(torch.float64)) * 0.5
    return torch.where(hi * hi < w64, up,
                       torch.where(lo * lo > w64, down, root))


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p(x) for -1 < x < inf, bit for bit as XLA's CPU
    backend computes it (the constants above)."""
    full = functools.partial(torch.full_like, x)
    # the rational branch
    x2 = x * x
    t0 = x * 0.0
    den = t0 + 1.0
    for c in LOG1P_DEN:
        den = fma32(den, x, c)
    num = t0 + LOG1P_NUM[0]
    for c in LOG1P_NUM[1:]:
        num = fma32(num, x, c)
    # a float64 quotient of float32 operands rounds to float32 correctly
    q = (num.double() / den.double()).to(torch.float32)
    small = x + fma32(x2, -0.5, (x * x2) * q)
    # logf(1 + x)
    u = torch.clamp(x + 1.0, min=2.0 ** -126)
    word = u.view(torch.int32)
    e = ((word >> 23) - 127).to(torch.float32) + 1.0
    m = ((word & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < LOGF_SQRTH
    r = (m - 1.0) + torch.where(below, m, full(0.0))
    e = e - torch.where(below, full(1.0), full(0.0))
    z = r * r
    r3 = z * r
    a, b, c = (fma32(fma32(r, c0, c1), r, c2)
               for c0, c1, c2 in LOGF_QUADRATICS)
    t = fma32(fma32(a, r3, b), r3, c)
    t = fma32(t, r3, e * LN2_LO)
    large = fma32(e, LN2_HI, fma32(z, -0.5, r) + t)
    return torch.where(x.abs() < LOG1P_SMALL, small, large)


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA computes it (Giles' polynomial, its Horner
    steps fused), for |x| < 1: bit for bit ``jax.lax.erf_inv`` on the
    CPU."""
    w = -log1p_xla(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt32(w) - 3.0)

    def coeff(i):
        return torch.where(small, torch.full_like(x, ERFINV_SMALL[i]),
                           ERFINV_LARGE[i])

    p = coeff(0)
    for i in range(1, len(ERFINV_SMALL)):
        p = fma32(p, w, coeff(i))
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
