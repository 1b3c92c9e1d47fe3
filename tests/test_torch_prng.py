"""The port's copy of JAX's threefry generator (utils/prng.py) and its
dispatch (kernels/threefry.py) against jax.random on the CPU.

Bits must be equal bit for bit; uniform and normal floats within rtol 1e-6
(float32 erfinv is the same polynomial on both sides, evaluated with other
roundings of log1p; float64 erfinv is torch's against XLA's); WORLD's slot
draw against the JAX synthesis's own ``_slot_noise``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.kernels import threefry
from diffsptk_tpu_torch.ops import world_common as twc
from diffsptk_tpu_torch.utils import prng

RTOL = 1e-6
SEEDS = [0, 42, 2 ** 40 + 5]
SHAPES = [(7,), (3, 5), (2, 3, 167), ()]


def _keys(seed):
    """(JAX key, port key) pairs: the seed's key, a split and a fold-in."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    return [(jk, tk),
            (jax.random.split(jk, 3)[2], prng.split(tk, 3)[2]),
            (jax.random.fold_in(jk, 123456789), prng.fold_in(tk, 123456789))]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)))
    for data in (0, 1, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            np.asarray(jax.random.fold_in(jk, np.uint32(data))))


def test_fold_in_batched_equals_vmap():
    data = np.array([[0, 5, 77], [4000, 4001, 2 ** 31 + 9]], np.int64)
    want = jax.vmap(jax.vmap(
        lambda d: jax.random.fold_in(jax.random.PRNGKey(3), d)))(
            jnp.asarray(data.astype(np.uint32)))
    got = prng.fold_in(prng.PRNGKey(3), torch.as_tensor(data))
    assert got.shape == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax(seed, shape, width):
    dtype = jnp.uint32 if width == 32 else jnp.uint64
    for jk, tk in _keys(seed):
        want = np.asarray(jax.random.bits(jk, shape, dtype))
        got = prng.bits(tk, shape, width).numpy()
        if width == 64:
            got = got.view(np.uint64)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_normal_match_jax(seed, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for jk, tk in _keys(seed):
        for shape in ((1001,), (4, 33)):
            np.testing.assert_allclose(
                prng.uniform(tk, shape, dtype).numpy(),
                np.asarray(jax.random.uniform(jk, shape, jdt)), rtol=RTOL,
                atol=0)
            np.testing.assert_allclose(
                prng.uniform(tk, shape, dtype, -3.0, 5.0).numpy(),
                np.asarray(jax.random.uniform(jk, shape, jdt, -3.0, 5.0)),
                rtol=RTOL, atol=0)
            got = prng.normal(tk, shape, dtype)
            assert got.dtype == dtype
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jax.random.normal(jk, shape, jdt)),
                rtol=RTOL, atol=0)


def test_normal_tails_match_jax():
    """Enough draws to reach erfinv's large-w branch (|u| near 1)."""
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    got = prng.normal(tk, (200_000,), torch.float32).numpy()
    want = np.asarray(jax.random.normal(jk, (200_000,), jnp.float32))
    assert np.abs(want).max() > 4.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slot_draw_equals_jax_slot_noise(dtype):
    """WorldSynthesis._slot_noise on both sides: counters (b + offset) *
    span + time_index, a repeated start, and a product past 2^31 (JAX's
    int32 arithmetic wraps)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ti = np.sort(np.random.default_rng(0).integers(0, 4000, (3, 9)), -1)
    ti[:, -3:] = ti[:, -4:-3]
    js = dsp.WorldSynthesis(80, 16000, 1024, seed=5)
    ts = pt.WorldSynthesis(80, 16000, 1024, seed=5, device="cpu")
    for span, offset in ((4000, 0), (4000, 2), (2 ** 30 + 3, 1)):
        want = js._slot_noise(jnp.asarray(ti, jnp.int32), span, offset, 130,
                              jdt)
        got = ts._slot_noise(torch.as_tensor(ti), span, offset, 130, dtype)
        assert got.shape == (3, 9, 130) and got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=0)


def test_slot_draw_row_zero_does_not_depend_on_batch():
    ti = torch.as_tensor(np.sort(np.random.default_rng(1).integers(
        0, 900, (4, 6)), -1))
    full = prng.slot_normal(0, ti, 900, 0, 50, torch.float64)
    np.testing.assert_array_equal(
        prng.slot_normal(0, ti[:1], 900, 0, 50, torch.float64).numpy(),
        full[:1].numpy())
    # and row 2 is row 0 of a draw that starts at batch offset 2
    np.testing.assert_array_equal(
        prng.slot_normal(0, ti[2:3], 900, 2, 50, torch.float64).numpy(),
        full[2:3].numpy())


def test_dither_is_jax_normal_of_key_zero():
    for dtype, jdt in ((torch.float64, jnp.float64),
                       (torch.float32, jnp.float32)):
        got = twc.dither_noise((2, 5, 64), dtype, "cpu")
        want = jax.random.normal(jax.random.PRNGKey(0), (2, 5, 64), jdt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=0)


def test_dispatch_on_the_cpu_takes_the_twin():
    before = threefry.launches
    key = prng.PRNGKey(9)
    np.testing.assert_array_equal(
        threefry.normal(key, (3, 4), torch.float32, "cpu").numpy(),
        prng.normal(key, (3, 4), torch.float32).numpy())
    ti = torch.tensor([[0, 3, 3]])
    np.testing.assert_array_equal(
        threefry.slot_normal(0, ti, 10, 0, 8, torch.float32).numpy(),
        prng.slot_normal(0, ti, 10, 0, 8, torch.float32).numpy())
    assert threefry.launches == before
    with pytest.raises(ValueError):
        threefry.normal_cuda(key, (3,), "cpu")
    with pytest.raises(ValueError):
        threefry.slot_normal_cuda(0, ti, 10, 0, 8)


def test_rejects_bad_keys_and_widths():
    with pytest.raises(TypeError):
        prng.bits(torch.zeros(3, dtype=torch.int64), (2,))
    with pytest.raises(TypeError):
        prng.bits(torch.zeros(2, dtype=torch.int32), (2,))
    with pytest.raises(ValueError):
        prng.bits(prng.PRNGKey(0), (2,), width=16)
    with pytest.raises(TypeError):
        prng.uniform(prng.PRNGKey(0), (2,), torch.float16)
