"""The designs of the SPD solve kernel (csrc/spd_solve.cu) and the scan
kernel (csrc/scan.cu), modelled in torch on the CPU.

- The solve kernel pads an order n to the next multiple of 8 with the
  identity (b with zeros).  ``spd_solve_padded`` does that in torch: at
  float64 it equals ``spd_solve_plain`` on the unpadded system within
  1e-12 for every n in 1..64, and at float32 the JAX Pallas kernel in
  interpret mode within 1e-4 of max|x| (tests/test_pallas_scan.py's bar).
- The scan kernel composes in its own order (per-thread runs, a warp
  tree, the aggregates of every earlier group of tiles and of the earlier
  tiles of a tile's own group, each set in a fixed tree).
  ``first_order_scan_tiled`` is that order in torch: at small tiles it
  equals ``first_order_scan_plain`` at float64 within 1e-12, and the
  Pallas scan in interpret mode within 2e-5 (float32) and 1e-4
  (complex64), at T = 1, a ragged last tile, an exact multiple of the tile
  and rows of more than one chunk of earlier groups.
Each JAX reference is computed once per module.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels import pallas_scan
from diffsptk_tpu.kernels.pallas_solve import spd_solve_pallas
from diffsptk_tpu_torch.kernels import scan, solve

SMALL = dict(per_thread=2, lanes=4, warps=2, chunk=4)   # tiles of 16
LENGTHS = (1, 16, 80, 149, 1100)
# T = 1, one tile, an exact multiple, ragged, and 69 tiles: 17 groups of 4,
# so the last tiles compose 5 chunks of earlier groups.


def _spd(rng, batch, n, dtype):
    M = rng.standard_normal((batch, n, n))
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    return A.astype(dtype), rng.standard_normal((batch, n)).astype(dtype)


def _scan_case(T, complex_, dtype):
    rng = np.random.default_rng(T + 100 * complex_)
    p = 0.9 * rng.uniform(-1, 1, (3, T))
    x = rng.standard_normal((3, T))
    if complex_:
        p = p * np.exp(1j * rng.uniform(0, 2 * np.pi, (3, T)))
        x = x + 1j * rng.standard_normal((3, T))
    return p.astype(dtype), x.astype(dtype)


@pytest.mark.parametrize("n", range(1, 65))
def test_padded_solve_equals_unpadded(n):
    A, b = _spd(np.random.default_rng(n), 3, n, np.float64)
    A, b = torch.as_tensor(A), torch.as_tensor(b)
    got = solve.spd_solve_padded(A, b)
    want = solve.spd_solve_plain(A, b)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-12


def test_padded_solve_matches_pallas_interpret():
    n = 13                                   # padded to 16
    A, b = _spd(np.random.default_rng(0), 40, n, np.float32)
    want = np.asarray(spd_solve_pallas(jnp.asarray(A), jnp.asarray(b),
                                       interpret=True))
    got = solve.spd_solve_padded(torch.as_tensor(A),
                                 torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def pallas_scans():
    """The Pallas scan in interpret mode on every case, once."""
    real_call = pallas_scan.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real_call(*args, **kwargs)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_scan.pl, "pallas_call", interp_call)
        pallas_scan.pallas_first_order_scan.clear_cache()
        try:
            for T in LENGTHS:
                for complex_ in (False, True):
                    p, x = _scan_case(T, complex_, np.complex64 if complex_
                                      else np.float32)
                    out[T, complex_] = np.asarray(
                        pallas_scan.pallas_first_order_scan(
                            jnp.asarray(p), jnp.asarray(x), chunk=128))
        finally:
            pallas_scan.pallas_first_order_scan.clear_cache()
    return out


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_tiled_scan_equals_plain(T, complex_):
    p, x = (torch.as_tensor(a) for a in _scan_case(
        T, complex_, np.complex128 if complex_ else np.float64))
    got = scan.first_order_scan_tiled(p, x, **SMALL)
    want = scan.first_order_scan_plain(p, x)
    assert float((got - want).abs().max()) < 1e-12


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("T", LENGTHS)
def test_tiled_scan_matches_pallas_interpret(pallas_scans, T, complex_):
    p, x = (torch.as_tensor(a) for a in _scan_case(
        T, complex_, np.complex64 if complex_ else np.float32))
    got = scan.first_order_scan_tiled(p, x, **SMALL).numpy()
    tol = 1e-4 if complex_ else 2e-5
    np.testing.assert_allclose(got, pallas_scans[T, complex_], rtol=tol,
                               atol=tol)


def test_tiled_scan_at_the_kernel_geometry():
    """The kernel's own geometry (tiles of 1,024, groups of 32) over 35
    tiles, so the last tiles compose the first group's aggregate and the
    earlier tiles of their own group."""
    assert 4 * 32 * 8 == scan.TILE
    rng = np.random.default_rng(5)
    T = 35 * scan.TILE - 7
    p = torch.as_tensor(0.9 * rng.uniform(-1, 1, (1, T)))
    x = torch.as_tensor(rng.standard_normal((1, T)))
    got = scan.first_order_scan_tiled(p, x)
    want = scan.first_order_scan_plain(p, x)
    assert float((got - want).abs().max()) < 1e-12
