"""Recursive filters of the port (kernels/recurrence.py) against the JAX
package's, on the same numpy inputs, float64 on the CPU: the first-order
recurrence (real, complex, any axis), the per-sample, blocked and chunked
all-pole recurrences, the FIR and lfilter.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels import recurrence as jrec
from diffsptk_tpu_torch.kernels import recurrence as rec
from diffsptk_tpu_torch.kernels import scan

# The JAX side jitted: eager JAX dispatches and compiles each op of the
# log-depth scans on its own, several seconds per case.
J_FIRST = jax.jit(jrec.first_order_recurrence, static_argnums=2)
J_LPC = jax.jit(jrec.sample_wise_lpc, static_argnames="block")
J_CHUNKED = jax.jit(jrec.chunked_sample_wise_lpc, static_argnums=(2, 3))

RTOL, ATOL = 1e-5, 1e-8


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("shape,axis", [((3, 500), -1), ((2, 2, 333), -1),
                                        ((40, 3), 0), ((2, 64, 3), 1)])
def test_first_order_recurrence_real(shape, axis):
    rng = _rng(0)
    x = rng.standard_normal(shape)
    p = 0.95 * rng.uniform(-1, 1, shape)
    want = J_FIRST(jnp.asarray(x), jnp.asarray(p), axis)
    before = scan.launches
    _close(rec.first_order_recurrence(_t(x), _t(p), axis), want)
    assert scan.launches == before


def test_first_order_recurrence_complex():
    rng = _rng(1)
    shape = (2, 700)
    p = 0.9 * np.exp(1j * rng.uniform(0, 2 * np.pi, shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    want = J_FIRST(jnp.asarray(x), jnp.asarray(p), -1)
    _close(rec.first_order_recurrence(_t(x), _t(p)), want)


def test_first_order_recurrence_broadcasts_p():
    rng = _rng(2)
    x = rng.standard_normal((3, 257))
    p = 0.8 * rng.uniform(-1, 1, 257)
    want = J_FIRST(jnp.asarray(x), jnp.asarray(np.broadcast_to(p, x.shape)),
                   -1)
    _close(rec.first_order_recurrence(_t(x), _t(p)), want)


def _lpc_coefs(rng, shape, M):
    return rng.uniform(-0.5, 0.5, shape + (M,)) / M


@pytest.mark.parametrize("M,T,block", [(1, 300, 256), (3, 200, 256),
                                       (3, 1024, 256), (4, 1100, 64),
                                       (24, 1024, 48), (2, 300, None)])
def test_sample_wise_lpc(M, T, block):
    """M=1 (the scan), the per-sample loop, and the exact blocked form,
    block-aligned and not."""
    rng = _rng(3)
    x = rng.standard_normal((2, T))
    a = _lpc_coefs(rng, (2, T), M)
    want = J_LPC(jnp.asarray(x), jnp.asarray(a), block=block)
    _close(rec.sample_wise_lpc(_t(x), _t(a), block=block), want)


@pytest.mark.parametrize("M,T", [(1, 200), (3, 200), (3, 1024)])
def test_sample_wise_lpc_initial_state(M, T):
    rng = _rng(4)
    x = rng.standard_normal((2, T))
    a = _lpc_coefs(rng, (2, T), M)
    zi = rng.standard_normal((2, M))
    want = J_LPC(jnp.asarray(x), jnp.asarray(a), zi=jnp.asarray(zi))
    _close(rec.sample_wise_lpc(_t(x), _t(a), zi=_t(zi)), want)


def test_sample_wise_lpc_order_zero():
    x = _t(_rng(5).standard_normal((2, 10)))
    assert rec.sample_wise_lpc(x, torch.zeros(2, 10, 0,
                                              dtype=x.dtype)) is x


def test_blocked_matches_plain_loop():
    rng = _rng(6)
    x = rng.standard_normal((2, 700))
    a = _lpc_coefs(rng, (2, 700), 5)
    zi = rng.standard_normal((2, 5))
    want = rec._scan_sample_wise_lpc(_t(x), _t(a), _t(zi))
    _close(rec.blocked_sample_wise_lpc(_t(x), _t(a), zi=_t(zi), block=32),
           want.numpy())


def test_sharded_path_is_not_ported():
    """The time-sharded path (once not ported) at one rank, on a trivial
    time axis with no process group: equal to the one-rank blocked form
    (the cross-rank fold has nothing to its left), at M = 1 too, where
    the one-rank op takes the scan; a block that does not divide the
    local length raises.  Across ranks: tests/test_torch_parallel.py."""
    from diffsptk_tpu_torch.parallel.mesh import Axis
    one = Axis(None, None)
    rng = _rng(3)
    for M in (1, 4):
        x = torch.as_tensor(rng.standard_normal((2, 512)))
        a = torch.as_tensor(0.2 * rng.standard_normal((2, 512, M)))
        got = rec.sample_wise_lpc(x, a, block=64, axis_name=one)
        want = rec.blocked_sample_wise_lpc(x, a, block=64)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="block"):
        rec.blocked_sample_wise_lpc(x[:, :100], a[:, :100], block=64,
                                    axis_name=one)


@pytest.mark.parametrize("M,C,W", [(1, 160, 40), (4, 256, 64),
                                   (24, 1024, 200)])
def test_chunked_sample_wise_lpc(M, C, W):
    rng = _rng(7)
    T = 4 * C
    x = rng.standard_normal((2, T))
    a = _lpc_coefs(rng, (2, T), M)
    want = J_CHUNKED(jnp.asarray(x), jnp.asarray(a), C, W)
    _close(rec.chunked_sample_wise_lpc(_t(x), _t(a), C, W), want)
    with pytest.raises(ValueError):
        rec.chunked_sample_wise_lpc(_t(x[:, :-1]), _t(a[:, :-1]), C, W)


def test_fir():
    rng = _rng(8)
    x = rng.standard_normal((3, 100))
    b = rng.standard_normal(7)
    want = jrec._fir(jnp.asarray(x), jnp.asarray(b))
    _close(rec._fir(_t(x), _t(b)), want)


@pytest.mark.parametrize("b,a", [([0.5, 0.25], [2.0]),
                                 ([1.0, -0.3], [1.0, -0.9]),
                                 ([0.2, 0.4, 0.2], [1.0, -0.5, 0.3]),
                                 ([1.0], [1.0, -1.2, 0.8, -0.2])])
def test_lfilter(b, a):
    x = _rng(9).standard_normal((2, 1500))
    want = jax.jit(lambda x: jrec.lfilter(np.asarray(b), np.asarray(a), x))(
        jnp.asarray(x))
    _close(rec.lfilter(b, a, _t(x)), want)
