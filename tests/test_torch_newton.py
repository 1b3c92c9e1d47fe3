"""Newton solve of the port (kernels/newton.py) on the CPU: its plain twin
against the JAX Pallas kernel in interpret mode, and its backward against
torch autograd through a dense solve.

Tolerances: 2e-4 (rtol and atol) against interpret mode and against a
float64 dense solve, as tests/test_pallas_newton.py holds the Pallas
kernel; 1e-6 / 1e-8 for the float64 backward.  Interpret mode traces the
fully unrolled kernel (tens of seconds at n=33), so the gate's upper
order n=33 is held against the dense solve."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels.pallas_newton import newton_solve_pallas
from diffsptk_tpu_torch.kernels import newton

RNG = np.random.default_rng(5)


def _system(n, B, dtype=np.float32):
    rt = RNG.standard_normal((B, 2 * n - 1)).astype(dtype) * 0.1
    rt[:, 0] += 4.0 + n * 0.2
    b = RNG.standard_normal((B, n)).astype(dtype)
    return rt, b


@pytest.mark.parametrize("n,B", [(1, 5), (6, 17), (25, 40)])
def test_twin_matches_pallas_interpret(n, B):
    rt, b = _system(n, B)
    want = np.asarray(newton_solve_pallas(jnp.asarray(rt), jnp.asarray(b),
                                          interpret=True))
    launches = newton.launches
    got = newton.newton_solve_t(torch.as_tensor(rt.T.copy()),
                                torch.as_tensor(b.T.copy()))
    np.testing.assert_allclose(got.numpy().T, want, rtol=2e-4, atol=2e-4)
    assert newton.launches == launches      # a CPU tensor runs the twin


@pytest.mark.parametrize("n,B", [(25, 30), (33, 12)])
def test_twin_matches_dense_solve(n, B):
    rt, b = _system(n, B)
    i = np.arange(n)
    A = (rt[:, np.abs(i[:, None] - i[None, :])]
         + rt[:, i[:, None] + i[None, :]]).astype(np.float64)
    want = np.linalg.solve(A, b.astype(np.float64)[..., None])[..., 0]
    got = newton.newton_solve_t(torch.as_tensor(rt.T.copy()),
                                torch.as_tensor(b.T.copy()))
    np.testing.assert_allclose(got.numpy().T, want, rtol=2e-4, atol=2e-4)


def test_backward_matches_dense_autograd():
    n, B = 9, 12
    rt, b = _system(n, B, np.float64)
    i = np.arange(n)
    idx_t = torch.as_tensor(np.abs(i[:, None] - i[None, :]))
    idx_h = torch.as_tensor(i[:, None] + i[None, :])

    r1 = torch.as_tensor(rt).requires_grad_(True)
    b1 = torch.as_tensor(b).requires_grad_(True)
    A = r1[:, idx_t] + r1[:, idx_h]
    want_x = torch.linalg.solve(A, b1[..., None])[..., 0]
    torch.sum(torch.sin(want_x)).backward()

    r2 = torch.as_tensor(rt.T.copy()).requires_grad_(True)
    b2 = torch.as_tensor(b.T.copy()).requires_grad_(True)
    x = newton.newton_solve_t(r2, b2)
    torch.sum(torch.sin(x)).backward()
    np.testing.assert_allclose(x.detach().numpy().T, want_x.detach().numpy(),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(r2.grad.numpy().T, r1.grad.numpy(),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(b2.grad.numpy().T, b1.grad.numpy(),
                               rtol=1e-6, atol=1e-8)


def test_nonpositive_pivot_gives_nan():
    """No clamp: an indefinite system gives NaN, as rsqrt does in JAX."""
    rt = torch.zeros(3, 1, dtype=torch.float64)
    rt[0] = -1.0
    x = newton.newton_solve_plain(rt, torch.ones(2, 1, dtype=torch.float64))
    assert torch.isnan(x).all()


def test_shape_checks():
    with pytest.raises(ValueError):
        newton.newton_solve_lane_major(torch.zeros(4, 3), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        newton.newton_solve_lane_major(torch.zeros(3, 3), torch.zeros(2, 4))
