"""The port's signal generators and utilities against the JAX package on
the CPU: impulse, step, ramp, sine and pulse train; Gaussian and uniform
noise under explicit keys (uniform draws bit for bit, normal draws within
three ulps at float32 and rtol 1e-10 at float64: ROADMAP C.13) and the
``_auto_key`` sequence of keyless calls; wav files written by either
package and read by the other (16-bit and float, mono and stereo); the
warping factor; checkpoints saved by either package and loaded by the
other; the throughput meter and the profiler trace.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py); a 16-bit wav round trip within 1/32768."""

from __future__ import annotations

import doctest
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu.utils import checkpoint as jckpt
from diffsptk_tpu_torch import signals
from diffsptk_tpu_torch.kernels import threefry
from diffsptk_tpu_torch.utils import checkpoint as tckpt
from diffsptk_tpu_torch.utils import prng
from diffsptk_tpu_torch.utils.profiling import Throughput, trace

J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DTYPES = [torch.float64, torch.float32]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,args,kw", [
    ("impulse", (5,), {}), ("step", (4,), dict(value=-2.5)),
    ("ramp", (4,), {}), ("ramp", (1, 3), dict(step=0.5)),
    ("ramp", (3.0, 0.0), dict(step=-0.7)),
    ("sin", (9,), {}), ("sin", (15,), dict(period=4.5, magnitude=2)),
    ("train", (20, 3), {}), ("train", (20, 2.5), dict(norm="magnitude")),
    ("train", (12, 4), dict(norm=0)),
])
def test_deterministic_signals(name, args, kw, dtype):
    want = getattr(dsp, name)(*args, **kw, dtype=J_DTYPE[dtype])
    got = getattr(pt, name)(*args, **kw, dtype=dtype, **CPU)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _same_normal(got, want, dtype):
    got, want = got.numpy(), np.asarray(want)
    if dtype == torch.float32:
        np.testing.assert_array_max_ulp(got, want, maxulp=3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_signals_with_keys(dtype):
    jd = J_DTYPE[dtype]
    key = jax.random.PRNGKey(11)
    tkey = torch.as_tensor(np.asarray(key), dtype=torch.int64)
    assert torch.equal(tkey, prng.PRNGKey(11))
    _same_normal(pt.nrand(3, 7, key=tkey, dtype=dtype, **CPU),
                 dsp.nrand(3, 7, key=key, dtype=jd), dtype)
    # scaled and shifted: three ulps of the draw, not of the result
    got = pt.nrand([2, 5], key=np.asarray(key), mean=1, var=4, dtype=dtype,
                   **CPU)
    want = dsp.nrand([2, 5], key=key, mean=1, var=4, dtype=jd)
    _same_normal((got - 1) / 2, (np.asarray(want) - 1) / 2, dtype)
    got = pt.rand(4, 9, key=tkey, a=-1, b=3, dtype=dtype, **CPU)
    want = dsp.rand(4, 9, key=key, a=-1, b=3, dtype=jd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    like = torch.zeros(2, 6, dtype=dtype)
    assert pt.nrand_like(like, key=tkey).shape == (2, 6)
    assert pt.rand_like(like, key=tkey).dtype == dtype
    assert pt.rand_like(like, key=tkey).device == like.device


@pytest.mark.parametrize("dtype", DTYPES)
def test_device_draws_take_the_twin_on_the_host(dtype):
    """On a host device ``kernels.threefry``'s draws are the twin's; a
    float32 uniform made as the card makes it, from the 32-bit draws and
    ``prng.to_range``, equals the twin's bit for bit."""
    key = prng.PRNGKey(13)
    torch.testing.assert_close(
        threefry.uniform(key, (4, 33), dtype, "cpu", -1, 3),
        prng.uniform(key, (4, 33), dtype, -1, 3), rtol=0, atol=0)
    torch.testing.assert_close(threefry.normal(key, (4, 33), dtype, "cpu"),
                               prng.normal(key, (4, 33), dtype),
                               rtol=0, atol=0)
    card_way = prng.to_range(prng.unit32(prng.bits(key, (4, 33))),
                             torch.float32, -1, 3)
    assert torch.equal(card_way, prng.uniform(key, (4, 33), torch.float32,
                                              -1, 3))


def test_auto_key_sequence(tmp_path):
    """Without a key, the n-th call in a fresh process draws what the JAX
    package's n-th call draws (each package in its own process)."""
    code_jax = ("import jax; jax.config.update('jax_enable_x64', True)\n"
                "import numpy as np, diffsptk_tpu as d\n"
                "a = [np.asarray(d.nrand(4)), np.asarray(d.rand(3)),\n"
                "     np.asarray(d.nrand(2, 2))]\n"
                "np.savez(OUT, *a)\n")
    code_pt = ("import sys\nsys.modules['jax'] = None\n"
               "import numpy as np, torch, diffsptk_tpu_torch as p\n"
               "kw = dict(device='cpu', dtype=torch.float64)\n"
               "a = [p.nrand(4, **kw), p.rand(3, **kw), p.nrand(2, 2, **kw)]\n"
               "np.savez(OUT, *[t.numpy() for t in a])\n")
    out = {}
    for name, code in (("jax", code_jax), ("pt", code_pt)):
        path = str(tmp_path / f"autokey_{name}.npz")
        run = subprocess.run(
            [sys.executable, "-c", code.replace("OUT", repr(path))],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert run.returncode == 0, run.stderr
        with np.load(path) as f:
            out[name] = [f[k] for k in sorted(f.files)]
    for got, want in zip(out["pt"], out["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_signals_doctests():
    result = doctest.testmod(signals, optionflags=doctest.ELLIPSIS)
    assert result.attempted >= 2 and result.failed == 0


@pytest.mark.parametrize("subtype", [None, "FLOAT"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wav_round_trip_across_packages(tmp_path, writer, subtype):
    """A mono and a stereo file written by one package read back in the
    other and in itself: within 1/32768 at 16 bits, exact as float."""
    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal((2, 800)) * 0.3, -1, 1)
    tol = 1 / 32768 if subtype is None else 1e-7
    for data in (x[0], x):
        path = str(tmp_path / f"{writer}_{data.ndim}.wav")
        if writer == "jax":
            dsp.write(path, jnp.asarray(data), 16000, subtype=subtype)
        else:
            pt.write(path, torch.as_tensor(data), 16000, subtype=subtype)
        y, sr = pt.read(path, dtype=torch.float64, **CPU)
        yj, srj = dsp.read(path)
        assert sr == srj == 16000
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(y.numpy(), data, rtol=0, atol=tol)
        yt, _ = pt.read(path, channel_first=False, **CPU)
        assert yt.dtype == torch.get_default_dtype()
        assert yt.shape == data.T.shape
    with pytest.raises(ValueError):
        pt.write(str(tmp_path / "x.wav"), x, 16000, subtype="PCM_24")


@pytest.mark.parametrize("sr", [8000, 16000, 22050, 44100, 48000])
@pytest.mark.parametrize("mode", ["hts", "auto"])
def test_get_alpha(sr, mode):
    assert pt.get_alpha(sr, mode) == dsp.get_alpha(sr, mode)


def test_get_alpha_checks():
    with pytest.raises(ValueError):
        pt.get_alpha(11025)
    with pytest.raises(ValueError):
        pt.get_alpha(16000, mode="mel")


TREE = {"mu": np.arange(6.0).reshape(2, 3), "w": np.array([0.25, 0.75]),
        "b": [np.eye(2), (np.ones(3), np.zeros(1))]}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_across_packages(tmp_path, writer):
    """A tree saved by either package loads in both, leaf for leaf in
    JAX's order (dict keys sorted, sequences in order), exactly."""
    path = str(tmp_path / "ckpt")
    if writer == "jax":
        jckpt.save(path, jax.tree.map(jnp.asarray, TREE), backend="npz")
    else:
        tckpt.save(path, {k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                              else v) for k, v in TREE.items()})
    like_t = {"mu": torch.zeros(2, 3, dtype=torch.float32),
              "w": torch.zeros(2, dtype=torch.float64),
              "b": [torch.zeros(2, 2), (torch.zeros(3), torch.zeros(1))]}
    got = tckpt.load(path, like_t)
    assert got["mu"].dtype == torch.float32
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    want = jckpt.load(path + ".npz", jax.tree.map(jnp.zeros_like,
                                                  jax.tree.map(jnp.asarray,
                                                               TREE)),
                      backend="npz")
    for g, w, t in zip(jax.tree.leaves(jax.tree.map(
            lambda v: v.numpy(), got)), jax.tree.leaves(want),
            jax.tree.leaves(TREE)):
        np.testing.assert_array_equal(np.asarray(w), t)
        np.testing.assert_array_equal(g, np.asarray(t, g.dtype))


def test_checkpoint_has_no_orbax(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        tckpt.save(str(tmp_path / "c"), {"a": torch.zeros(1)},
                   backend="orbax")
    with pytest.raises(ValueError):
        tckpt.load(str(tmp_path / "c"), {"a": torch.zeros(1)},
                   backend="zarr")


def test_throughput_and_trace(tmp_path):
    stft = pt.STFT(100, 50, 128, device="cpu")
    x = pt.nrand(1599, key=prng.PRNGKey(0), **CPU)
    meter = Throughput(stft, warmup=1, iters=2)
    assert meter.measure(x, n_samples=x.numel()) > 0
    assert meter.last_seconds_per_call > 0
    with trace(str(tmp_path / "prof")):
        stft(x)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
