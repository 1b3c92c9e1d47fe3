"""The port's stateless ``functional`` API against the JAX package's on the
CPU: each of its 100 functions once on the same float64 input (rtol 1e-5 /
atol 1e-8, tests/utils.py), the contract that the class path equals the
functional path (tests/test_contracts.py:70) at float64 and float32, the
operator cache behind it, and the names the two packages share (all 183
of the JAX package's public non-module names, each of the same kind, with
``functional`` and ``__version__``).

Every JAX reference is the functional call, jitted where it can be traced
(eager where not), computed once per case.
The random functions draw from keys the two packages share: Griffin-Lim's
initial phase is ``jax.random.uniform``'s, equal bit for bit, and
``excite``'s Gaussian noise ``jax.random.normal``'s, which the port
reproduces to three ulps (ROADMAP C.13), far inside the bar."""

from __future__ import annotations

import doctest
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from chip_smoke import functional_cases
from diffsptk_tpu import functional as JF
from diffsptk_tpu_torch import functional as F
from diffsptk_tpu_torch.core import _operator

RNG = np.random.default_rng(62)
# name -> (positional inputs, keyword arguments), shared with chip_smoke.py's
# [functional]; every array input goes to both packages, as jnp on the JAX
# side and torch on the port's.
CASES = functional_cases(torch)
X = CASES["frame"][0][0]                                       # (2, 400)
R = CASES["levdur"][0][0]                                      # (2, 5, 9)


def _functions(mod):
    return sorted(n for n, v in vars(mod).items()
                  if inspect.isfunction(v) and not n.startswith("_")
                  and v.__module__ == mod.__name__)


def test_every_function_has_a_case():
    """The 100 functions of the JAX package (and ``iwht``, another name
    of ``wht``) have a case, and the port's have their signatures."""
    names = _functions(JF)
    assert len({id(getattr(JF, n)) for n in names}) == 100
    assert sorted(CASES) == names
    assert _functions(F) == names
    for name in names:
        assert (inspect.signature(getattr(F, name))
                == inspect.signature(getattr(JF, name))), name


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in _leaves(o)]
    return [out]


def _call(fn, args, kw, conv):
    def c(v):
        return conv(v) if isinstance(v, np.ndarray) else v
    return fn(*(c(a) for a in args), **{k: c(v) for k, v in kw.items()})


def _torch(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.complex128 if np.iscomplexobj(a)
                           else torch.float64)


def _jax_reference(name, args, kw):
    """The JAX package's function on the case, jitted with its non-array
    arguments fixed (eager where it cannot be traced)."""
    fn = getattr(JF, name)
    pos = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]
    keys = [k for k, v in kw.items() if isinstance(v, np.ndarray)]

    def call(*arrays):
        a, k = list(args), dict(kw)
        for i, v in zip(pos, arrays[:len(pos)]):
            a[i] = v
        k.update(zip(keys, arrays[len(pos):]))
        return fn(*a, **k)

    arrays = [jnp.asarray(args[i]) for i in pos] + [jnp.asarray(kw[k])
                                                    for k in keys]
    try:
        return jax.jit(call)(*arrays)
    except (jax.errors.JAXTypeError, jax.errors.ConcretizationTypeError,
            TypeError):
        return call(*arrays)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    args, kw = CASES[name]
    int_args = name == "dtw_merge"
    want = _leaves(_jax_reference(name, args, kw))
    got = _leaves(_call(getattr(F, name), args, kw,
                        (lambda a: torch.as_tensor(a)) if int_args
                        else _torch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-8, err_msg=name)


# the cases of tests/test_contracts.py:70: (name, class, functional, input)
FRAMES = RNG.standard_normal((6, 32))
VEC = RNG.standard_normal((6, 9))
SPEC = np.abs(np.fft.rfft(FRAMES, n=64)) ** 2 + 1e-6
CONTRACT = [
    ("frame", lambda **k: pt.Frame(32, 16, **k),
     lambda x: F.frame(x, 32, 16), X[0]),
    ("window", lambda **k: pt.Window(32, **k), F.window, FRAMES),
    ("stft", lambda **k: pt.STFT(32, 16, 64, **k),
     lambda x: F.stft(x, frame_length=32, frame_period=16, fft_length=64),
     X[0]),
    ("dct", lambda **k: pt.DCT(32, **k), F.dct, FRAMES),
    ("wht", lambda **k: pt.WHT(32, **k), F.wht, FRAMES),
    ("mdct", lambda **k: pt.MDCT(32, **k),
     lambda x: F.mdct(x, frame_length=32), X[0]),
    ("acorr", lambda **k: pt.Autocorrelation(32, 8, **k),
     lambda x: F.acorr(x, acr_order=8), FRAMES),
    ("lpc", lambda **k: pt.LPC(32, 8, **k),
     lambda x: F.lpc(x, lpc_order=8), FRAMES),
    ("mcep", lambda **k: pt.MelCepstralAnalysis(
        fft_length=64, cep_order=8, alpha=0.42, n_iter=2, **k),
     lambda s: F.mcep(s, cep_order=8, alpha=0.42, n_iter=2), SPEC),
    ("freqt", lambda **k: pt.FrequencyTransform(8, 8, 0.42, **k),
     lambda c: F.freqt(c, out_order=8, alpha=0.42), VEC),
    ("mc2b", lambda **k: pt.MelCepstrumToMLSADigitalFilterCoefficients(
        8, alpha=0.42, **k), lambda c: F.mc2b(c, alpha=0.42), VEC),
    ("gnorm", lambda **k: pt.GeneralizedCepstrumGainNormalization(
        8, gamma=-0.5, **k), lambda c: F.gnorm(c, gamma=-0.5), VEC),
    ("fbank", lambda **k: pt.FBANK(fft_length=64, n_channel=8,
                                   sample_rate=16000, **k),
     lambda s: F.fbank(s, n_channel=8, sample_rate=16000), SPEC),
    ("alaw", lambda **k: pt.ALawCompression(**k), F.alaw, X[0]),
    ("ulaw", lambda **k: pt.MuLawCompression(**k), F.ulaw, X[0]),
    ("quantize", lambda **k: pt.UniformQuantization(**k), F.quantize,
     X[0]),
    ("delta", lambda **k: pt.Delta([[-0.5, 0.0, 0.5]], **k),
     lambda v: F.delta(v, seed=[[-0.5, 0.0, 0.5]]), VEC),
    ("entropy", lambda **k: pt.Entropy(**k), F.entropy,
     np.abs(VEC[:, :8]) / np.abs(VEC[:, :8]).sum(-1, keepdims=True)),
    ("zcross", lambda **k: pt.ZeroCrossingAnalysis(32, **k),
     lambda x: F.zcross(x, frame_length=32), X[0]),
    ("levdur", lambda **k: pt.LevinsonDurbin(8, **k), F.levdur,
     R.reshape(-1, 9)),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", CONTRACT, ids=[c[0] for c in CONTRACT])
def test_class_equals_functional(case, dtype):
    """The class and the function on one input give the same values, at
    the input's dtype (the function builds its operator in it)."""
    name, mk_class, fn, x = case
    xt = torch.as_tensor(x, dtype=dtype)
    got_cls = mk_class(device="cpu", dtype=dtype)(xt)
    got_fn = fn(xt)
    if isinstance(got_cls, tuple):
        got_cls, got_fn = got_cls[0], got_fn[0]
    assert got_fn.dtype == got_cls.dtype
    torch.testing.assert_close(got_fn, got_cls, rtol=1e-12, atol=1e-12)


def test_operator_cache():
    """One operator per argument set, device and dtype; a list argument
    is a key, an array argument builds anew."""
    x = torch.as_tensor(FRAMES)
    _operator.cache_clear()
    F.dct(x)
    F.dct(x)
    info = _operator.cache_info()
    assert (info.misses, info.hits, info.currsize) == (1, 1, 1)
    F.dct(x.float())
    assert _operator.cache_info().currsize == 2
    a = F.dfs(x, b=[1.0, 0.5])
    n = _operator.cache_info().currsize
    b = F.dfs(x, b=np.asarray([1.0, 0.5]))
    assert _operator.cache_info().currsize == n
    torch.testing.assert_close(a, b)
    assert F.acorr(x.float(), 4).dtype == torch.float32
    assert F.fftr(x.to(torch.complex128).real, 64).dtype == torch.complex128


def test_functional_doctests():
    result = doctest.testmod(F, optionflags=doctest.ELLIPSIS)
    assert result.attempted >= 3 and result.failed == 0


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))}


def test_all_shared_names():
    """Every public non-module name of the JAX package (183) is the
    port's too, of the same kind; so are ``functional``, ``__version__``
    and the ``ops`` submodules that ``from .ops import *`` puts on it."""
    jax_names = _public(dsp)
    assert len(jax_names) == 183
    missing = sorted(jax_names - _public(pt))
    assert not missing, missing
    differ = [n for n in sorted(jax_names)
              if inspect.isclass(getattr(dsp, n))
              != inspect.isclass(getattr(pt, n))
              or inspect.isfunction(getattr(dsp, n))
              != inspect.isfunction(getattr(pt, n))]
    assert not differ, differ
    assert isinstance(pt.functional, types.ModuleType)
    assert pt.__version__ == dsp.__version__ == "0.1.0"
    # ``parallel`` appears once a test imports it; it is A.9, not ported
    jax_mods = {n for n in dir(dsp) if isinstance(getattr(dsp, n),
                                                  types.ModuleType)}
    jax_mods.discard("parallel")
    port_mods = {n for n in dir(pt) if isinstance(getattr(pt, n),
                                                  types.ModuleType)}
    assert jax_mods <= port_mods, sorted(jax_mods - port_mods)
    assert set(pt.__all__) == _public(pt)
