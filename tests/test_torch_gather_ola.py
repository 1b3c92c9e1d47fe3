"""The windowed gather (B6) and the overlap-add (B7) of the port against the
JAX package on the CPU: the plain twins against ``gather_windows`` and
``overlap_add`` (whose CPU path is the XLA fallback, the reference of the
Pallas kernels, which have no interpret mode), their backwards against
``jax.vjp``, and the overlap-add's range check.

Tolerances: the gather is a copy and its twin must equal the fallback
exactly; the overlap-add and both backwards are sums in another order,
held at rtol 1e-5 / atol 1e-6 at float32 (and rtol 1e-5 / atol 1e-8 at
float64 for the backwards)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels.pallas_gather import gather_windows as j_gather
from diffsptk_tpu.kernels.pallas_ola import overlap_add as j_ola
from diffsptk_tpu_torch.kernels import gather, ola

RNG = np.random.default_rng(61)


def _starts(B, N, lo, hi, seed=0):
    return np.random.default_rng(seed).integers(lo, hi, (B, N)).astype(
        np.int32)


@pytest.mark.parametrize("B,T,N,length,lo,hi", [
    (3, 500, 40, 37, 0, 464),         # in range
    (2, 300, 25, 64, -80, 330),       # both edges clamped
    (1, 64, 7, 100, -5, 10),          # windows longer than the row
])
def test_gather_twin_matches_jax(B, T, N, length, lo, hi):
    x = RNG.standard_normal((B, T)).astype(np.float32)
    s = _starts(B, N, lo, hi)
    want = np.asarray(j_gather(jnp.asarray(x), jnp.asarray(s), length))
    got = gather.gather_windows_plain(torch.as_tensor(x), torch.as_tensor(s),
                                      length)
    np.testing.assert_array_equal(got.numpy(), want)
    before = gather.launches
    entry = gather.gather_windows(torch.as_tensor(x), torch.as_tensor(s),
                                  length)
    assert gather.launches == before          # a CPU tensor runs the twin
    np.testing.assert_array_equal(entry.numpy(), want)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6),
                                        (np.float64, 1e-8)])
def test_gather_backward_matches_jax(dtype, atol):
    """The adjoint overlap-add, clamped overhangs folded onto the edge
    samples."""
    B, T, N, length = 2, 200, 30, 48
    x = RNG.standard_normal((B, T)).astype(dtype)
    s = _starts(B, N, -60, 230, seed=1)
    g = RNG.standard_normal((B, N, length)).astype(dtype)
    _, vjp = jax.vjp(lambda v: j_gather(v, jnp.asarray(s), length),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    gather.gather_windows(xt, torch.as_tensor(s), length).backward(
        torch.as_tensor(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


def _slots(B, P, out_len, L, seed=2):
    """Nondecreasing starts in [0, out_len - L], with repeats (WORLD's
    invalid slots repeat the last pulse)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, out_len - L + 1, (B, P)), axis=-1)
    t[:, -3:] = t[:, -4:-3]
    return t.astype(np.int32)


@pytest.mark.parametrize("B,P,L,out_len", [(2, 40, 64, 700), (3, 9, 128, 128),
                                           (1, 70, 33, 400)])
def test_ola_twin_matches_jax(B, P, L, out_len):
    t = _slots(B, P, out_len, L)
    r = RNG.standard_normal((B, P, L)).astype(np.float32)
    want = np.asarray(j_ola(jnp.asarray(t), jnp.asarray(r), out_len))
    before = ola.launches
    got = ola.overlap_add(torch.as_tensor(t), torch.as_tensor(r), out_len)
    assert ola.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ola.overlap_add_plain(torch.as_tensor(t), torch.as_tensor(r),
                              out_len).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6),
                                        (np.float64, 1e-8)])
def test_ola_backward_matches_jax(dtype, atol):
    """The adjoint is the gather of the output gradient at the starts."""
    B, P, L, out_len = 2, 25, 40, 500
    t = _slots(B, P, out_len, L, seed=3)
    r = RNG.standard_normal((B, P, L)).astype(dtype)
    g = RNG.standard_normal((B, out_len)).astype(dtype)
    _, vjp = jax.vjp(lambda v: j_ola(jnp.asarray(t), v, out_len),
                     jnp.asarray(r))
    (want,) = vjp(jnp.asarray(g))
    rt = torch.as_tensor(r).requires_grad_(True)
    ola.overlap_add(torch.as_tensor(t), rt, out_len).backward(
        torch.as_tensor(g))
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_ola_range_check():
    """Starts outside [0, out_len - L] or decreasing along a row raise;
    the edges of the range are accepted."""
    r = torch.ones(1, 3, 10)
    ola.overlap_add(torch.tensor([[0, 5, 20]]), r, 30)
    with pytest.raises(ValueError, match="lie in"):
        ola.overlap_add(torch.tensor([[-1, 5, 20]]), r, 30)
    with pytest.raises(ValueError, match="lie in"):
        ola.overlap_add(torch.tensor([[0, 5, 21]]), r, 30)
    with pytest.raises(ValueError, match="nondecreasing"):
        ola.overlap_add(torch.tensor([[0, 7, 5]]), r, 30)
    with pytest.raises(TypeError):
        ola.overlap_add(torch.tensor([[0.0, 5.0, 20.0]]), r, 30)
    with pytest.raises(ValueError):
        ola.overlap_add(torch.tensor([[0, 5]]), r, 30)


def test_wrappers_reject_cpu_tensors_for_the_kernel():
    """The kernel entries take CUDA tensors only; nothing falls back."""
    x = torch.zeros(1, 10)
    with pytest.raises(ValueError, match="CUDA"):
        gather.gather_windows_cuda(x, torch.zeros(1, 2, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ola.overlap_add_cuda(torch.zeros(1, 2, dtype=torch.int32),
                             torch.zeros(1, 2, 4), 10)
    with pytest.raises(TypeError):
        gather.gather_windows(x, torch.zeros(1, 2), 4)


@pytest.mark.parametrize("B,P,L,out_len,repeat", [
    (2, 200, 64, 3000, 150), (3, 1, 10, 40, 0), (1, 65, 33, 90, 0),
    (2, 130, 257, 5000, 60), (2, 64, 5, 5, 0)])
def test_ola_grouped_matches_twin(B, P, L, out_len, repeat):
    """The kernel's two-pass order in torch (groups of ola.GROUP slots
    into a workspace, then each output's covering groups) against the
    index_add twin at float64, with and without a permutation of the
    response rows; runs of equal starts, one slot, a second group of one
    slot, windows as long as the row."""
    t = torch.as_tensor(_slots(B, P, out_len, L, seed=4) if P > 3 else
                        np.sort(RNG.integers(0, out_len - L + 1, (B, P)), -1))
    if repeat:
        t[:, -repeat:] = t[:, -repeat - 1:-repeat]
    r = torch.as_tensor(RNG.standard_normal((B, P, L)))
    want = ola.overlap_add_plain(t, r, out_len)
    torch.testing.assert_close(ola.overlap_add_grouped(t, r, out_len), want,
                               rtol=1e-12, atol=1e-12)
    perm = torch.as_tensor(np.stack([RNG.permutation(P) for _ in range(B)]))
    torch.testing.assert_close(
        ola.overlap_add_grouped(t, r, out_len, perm=perm),
        ola.overlap_add_plain(t, torch.gather(r, 1, perm[..., None].expand(
            -1, -1, L)), out_len), rtol=1e-12, atol=1e-12)


def test_ola_unchecked_skips_the_range_check_only():
    """check=False (WORLD's synthesis, whose slot table is in range and
    sorted by construction) reads nothing back; shapes and types are still
    checked."""
    r = torch.ones(1, 3, 10)
    t = torch.tensor([[0, 5, 20]])
    torch.testing.assert_close(ola.overlap_add(t, r, 30, check=False),
                               ola.overlap_add(t, r, 30))
    with pytest.raises(TypeError):
        ola.overlap_add(t.double(), r, 30, check=False)
    with pytest.raises(ValueError):
        ola.overlap_add(t[:, :2], r, 30, check=False)
