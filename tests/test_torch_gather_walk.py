"""The windowed gather kernel's index arithmetic (csrc/gather.cu), repeated
on the CPU by kernels/gather.py: the division by a host-side reciprocal
(``split_index``) against ``//`` and ``%``, and the flat index walk
(``gather_windows_walk``) against the plain twin and the JAX package's
``gather_windows``.

Every comparison is exact: the division is integer arithmetic and the
gather a copy.  The largest site of one WORLD D4C call (32 x 19,200
samples at 16 kHz, 5 ms frames) gathers 64 rows x 241 windows x 1,026
samples, so every flat index up to that count is divided by each window
length the sites use and by the small lengths where a step of 32 crosses
several windows."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels.pallas_gather import gather_windows as j_gather
from diffsptk_tpu_torch.kernels import gather

LARGEST_SITE = 64 * 241 * 1026
CHUNK = 1 << 21


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 79, 156, 241, 514, 1026])
def test_split_index_matches_floor_division(d):
    inv = 1.0 / d
    for lo in range(0, LARGEST_SITE + 1, CHUNK):
        a = torch.arange(lo, min(lo + CHUNK, LARGEST_SITE + 1))
        q, r = gather.split_index(a, d, inv)
        assert torch.equal(q, a // d) and torch.equal(r, a % d), (d, lo)


@pytest.mark.parametrize("d", [1, 3, 79, 1026, 65535, 2**31 - 1])
def test_split_index_far_from_zero(d):
    """64-bit flat indices, up to the kernel's limit of 2**53."""
    a = torch.as_tensor(np.random.default_rng(d).integers(
        0, 2**53, 200_000, dtype=np.int64))
    a = torch.cat([a, torch.tensor([0, d - 1, d, 2**53 - 1])])
    q, r = gather.split_index(a, d, 1.0 / d)
    assert torch.equal(q, a // d) and torch.equal(r, a % d)


# B, T, N, length, lo, hi: starts drawn from [lo, hi)
EDGES = [
    (3, 500, 40, 1, -90, 480),        # a step of 32 crosses 32 windows
    (3, 500, 41, 3, -90, 480),        # N L = 369, not a multiple of 4
    (2, 3000, 33, 79, -100, 3100),    # starts below 0 and past T
    (2, 800, 11, 1026, -300, 900),    # windows longer than the row
    (1, 64, 7, 100, -5, 10),
    (5, 700, 3, 37, 600, 760),        # rows end inside a warp's span
]


def _case(B, T, N, length, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T)).astype(np.float32)
    s = rng.integers(lo, hi, (B, N)).astype(np.int32)
    return x, s


@pytest.mark.parametrize("B,T,N,length,lo,hi", EDGES)
def test_walk_matches_plain(B, T, N, length, lo, hi):
    x, s = (torch.as_tensor(a) for a in _case(B, T, N, length, lo, hi))
    assert torch.equal(gather.gather_windows_walk(x, s, length),
                       gather.gather_windows_plain(x, s, length))


@pytest.mark.parametrize("B,T,N,length,lo,hi", EDGES[1:4])
def test_walk_matches_jax(B, T, N, length, lo, hi):
    x, s = _case(B, T, N, length, lo, hi, seed=1)
    want = np.asarray(j_gather(jnp.asarray(x), jnp.asarray(s), length))
    got = gather.gather_windows_walk(torch.as_tensor(x), torch.as_tensor(s),
                                     length)
    np.testing.assert_array_equal(got.numpy(), want)
