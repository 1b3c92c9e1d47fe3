"""The twins of the SPD solve kernel (kernels/solve.py) and the scan kernel
(kernels/scan.py) against the JAX Pallas kernels in interpret mode, at
float32 on the CPU, and their autograd Functions against autograd through
the plain forms at float64.

Tolerances, as tests/test_pallas_scan.py holds the Pallas kernels: the
solve within 1e-4 of max|x| against interpret mode and a float64 solve;
its backward rtol 1e-3 / atol 1e-4 on b_bar and on the symmetrised A_bar
(at float32 there; float64 here, so 1e-6 / 1e-8).  The scan within 2e-5
(real) and 1e-4 (complex64) of interpret mode; its backward at float64
within 1e-6 / 1e-8."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels import pallas_scan
from diffsptk_tpu.kernels.pallas_solve import spd_solve_pallas
from diffsptk_tpu_torch.kernels import scan, solve
from diffsptk_tpu_torch.utils.linalg import spd_solve


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(rng, batch, n, dtype=np.float32):
    M = rng.standard_normal((batch, n, n))
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    b = rng.standard_normal((batch, n))
    return A.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("batch,n", [(600, 13), (40, 24), (7, 26), (3, 64)])
def test_solve_twin_matches_pallas_interpret(batch, n):
    A, b = _spd(_rng(n), batch, n)
    want = np.asarray(spd_solve_pallas(jnp.asarray(A), jnp.asarray(b),
                                       interpret=True))
    before = solve.launches
    got = solve.spd_solve_batched(torch.as_tensor(A),
                                  torch.as_tensor(b)).numpy()
    assert solve.launches == before          # a CPU tensor runs the twin
    exact = np.linalg.solve(A.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() < 1e-4 * scale
    assert np.abs(got - exact).max() < 1e-4 * scale


def test_solve_reads_the_lower_triangle():
    A, b = _spd(_rng(1), 5, 16)
    upper = np.triu(_rng(2).standard_normal((16, 16)), 1).astype(np.float32)
    got = solve.spd_solve_batched(torch.as_tensor(A + upper),
                                  torch.as_tensor(b))
    want = solve.spd_solve_batched(torch.as_tensor(A), torch.as_tensor(b))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_solve_backward_matches_autograd():
    A, b = _spd(_rng(3), 6, 9, np.float64)
    A1 = torch.as_tensor(A).requires_grad_(True)
    b1 = torch.as_tensor(b).requires_grad_(True)
    torch.sin(solve.spd_solve_plain(A1, b1)).sum().backward()
    A2 = torch.as_tensor(A).requires_grad_(True)
    b2 = torch.as_tensor(b).requires_grad_(True)
    torch.sin(solve.spd_solve_diff(A2, b2)).sum().backward()
    np.testing.assert_allclose(b2.grad.numpy(), b1.grad.numpy(), rtol=1e-6,
                               atol=1e-8)

    # The plain form's autograd sees the lower triangle only, the
    # Function's backward gives the full -z x^T; both symmetrise alike.
    sym = lambda t: (t + t.transpose(-1, -2)).numpy()  # noqa: E731
    np.testing.assert_allclose(sym(A2.grad), sym(A1.grad), rtol=1e-6,
                               atol=1e-8)


def test_solve_backward_matches_dense_solve():
    """b_bar and the symmetrised A_bar of the Function against autograd
    through a dense solve of the symmetric matrix."""
    A, b = _spd(_rng(4), 5, 14, np.float64)
    G = torch.as_tensor(A).requires_grad_(True)
    b1 = torch.as_tensor(b).requires_grad_(True)
    S = 0.5 * (G + G.transpose(-1, -2))
    torch.cos(torch.linalg.solve(S, b1[..., None])[..., 0]).sum().backward()
    A2 = torch.as_tensor(A).requires_grad_(True)
    b2 = torch.as_tensor(b).requires_grad_(True)
    torch.cos(solve.spd_solve_diff(A2, b2)).sum().backward()
    np.testing.assert_allclose(b2.grad.numpy(), b1.grad.numpy(), rtol=1e-6,
                               atol=1e-8)
    sym = lambda t: (t + t.transpose(-1, -2)).numpy()  # noqa: E731
    np.testing.assert_allclose(sym(A2.grad), sym(G.grad), rtol=1e-6,
                               atol=1e-8)


def test_solve_indefinite_gives_nan():
    """No clamp: a non-positive pivot gives NaN, as rsqrt does in JAX."""
    A = torch.eye(3, dtype=torch.float64)[None].repeat(2, 1, 1)
    A[:, 0, 0] = -1.0
    x = solve.spd_solve_batched(A, torch.ones(2, 3, dtype=torch.float64))
    assert torch.isnan(x[:, 0]).all()


def test_solve_checks():
    f32 = dict(dtype=torch.float32)
    with pytest.raises(ValueError):
        solve.spd_solve_batched(torch.zeros(2, 3, 4, **f32),
                                torch.zeros(2, 3, **f32))
    with pytest.raises(ValueError):
        solve.spd_solve_batched(torch.zeros(2, 3, 3, **f32),
                                torch.zeros(3, 3, **f32))
    with pytest.raises(ValueError):
        solve.spd_solve_batched(torch.zeros(2, 3, 3, **f32),
                                torch.zeros(2, 3, dtype=torch.float64))


@pytest.mark.parametrize("batch,n", [(3000, 24), (10, 24), (3000, 8)])
def test_linalg_dispatch_on_cpu(batch, n):
    """On the CPU every dispatch branch is plain and matches float64."""
    A, b = _spd(_rng(5), batch, n)
    before = solve.launches
    got = spd_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    assert solve.launches == before
    exact = np.linalg.solve(A.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    assert np.abs(got - exact).max() < 1e-4 * np.abs(exact).max()


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas scan in interpret mode (tests/test_pallas_scan.py)."""
    import jax.experimental.pallas as pl
    real_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real_call(*args, **kwargs)

    monkeypatch.setattr(pallas_scan.pl, "pallas_call", interp_call)
    pallas_scan.pallas_first_order_scan.clear_cache()
    yield
    pallas_scan.pallas_first_order_scan.clear_cache()


@pytest.mark.parametrize("shape", [(3, 500), (1, 2049), (2, 2, 300)])
def test_scan_twin_matches_pallas_interpret(interpret, shape):
    rng = _rng(6)
    p = (0.9 * rng.uniform(-1, 1, shape)).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(pallas_scan.pallas_first_order_scan(
        jnp.asarray(p), jnp.asarray(x), chunk=256))
    before = scan.launches
    got = scan.first_order_scan(torch.as_tensor(p), torch.as_tensor(x))
    assert scan.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_scan_twin_matches_pallas_interpret_complex(interpret):
    rng = _rng(7)
    shape = (2, 700)
    p = (0.8 * np.exp(1j * rng.uniform(0, 6.28, shape))).astype(np.complex64)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = np.asarray(pallas_scan.pallas_first_order_scan(
        jnp.asarray(p), jnp.asarray(x), chunk=256))
    got = scan.first_order_scan(torch.as_tensor(p), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _assoc_grads(p, x, loss):
    """Gradients of ``loss`` through JAX's associative scan."""
    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    def f(p, x):
        return loss(jax.lax.associative_scan(combine, (p, x), axis=-1)[1])

    return jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(p),
                                                jnp.asarray(x))


@pytest.mark.parametrize("complex_", [False, True])
def test_scan_backward_matches_autograd(complex_):
    rng = _rng(8)
    shape = (2, 400)
    p = 0.9 * rng.uniform(-1, 1, shape)
    x = rng.standard_normal(shape)
    if complex_:
        p = p * np.exp(1j * rng.uniform(0, 6.28, shape))
        x = x + 1j * rng.standard_normal(shape)
    p1 = torch.as_tensor(p).requires_grad_(True)
    x1 = torch.as_tensor(x).requires_grad_(True)
    y = scan.first_order_scan_plain(p1, x1)
    (torch.sin(y.real) + torch.cos(y.imag) if complex_
     else torch.sin(y)).sum().backward()
    p2 = torch.as_tensor(p).requires_grad_(True)
    x2 = torch.as_tensor(x).requires_grad_(True)
    y = scan.scan_diff(p2, x2)
    (torch.sin(y.real) + torch.cos(y.imag) if complex_
     else torch.sin(y)).sum().backward()
    for got, want in ((p2.grad, p1.grad), (x2.grad, x1.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-8)
    if not complex_:
        gp, gx = _assoc_grads(p, x, lambda y: jnp.sum(jnp.sin(y)))
        np.testing.assert_allclose(p2.grad.numpy(), np.asarray(gp),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(x2.grad.numpy(), np.asarray(gx),
                                   rtol=1e-6, atol=1e-8)


def test_scan_checks():
    with pytest.raises(ValueError):
        scan.first_order_scan(torch.zeros(2, 5), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        scan.first_order_scan(torch.zeros(2, 5, dtype=torch.float32),
                              torch.zeros(2, 5, dtype=torch.float64))
