"""The port's pitch-network trainers (tools/torch_train_fcnf0.py,
tools/torch_train_crepe_tiny.py) held to the JAX trainers
(tools/train_fcnf0.py, tools/train_crepe_tiny.py) on the CPU, at batch 2
to 4.  Both sides' tools are loaded by path; each JAX reference is
computed once per module.

* The numpy corpora equal the JAX trainers' exactly for the same
  generator seed; ``prng.randint`` equals ``jax.random.randint`` bit for
  bit (int32 and, under x64, int64, JAX's default integer there); a
  float32 ``prng.uniform`` on [minval, maxval) equals JAX's bit for bit.
* The device corpus at float64 equals JAX's under x64 at rtol 1e-5 / atol
  1e-8.  At float32 its draws equal JAX's float32 draws bit for bit; its
  values (phase arguments near 5e4 rad, where a float32 ulp is 4e-3 rad)
  are held to the float64 corpus on the same draws within
  ``CORPUS32_BARS``, ten times the CPU reading (x 1.08e-4 of max|x|,
  target 1.87e-5 of its max, six seeds at batch 64:
  tools/torch_train_readings.py), where JAX's own float32 corpus lies
  too.
* FCNF0's loss and gradients at ``init_fcnf0_params(0)`` (float32, full
  fp32) within 1e-4 of max|g| of ``jax.value_and_grad`` of the trainer's
  loss, and at the bundled checkpoint the loss within rtol 1e-5.  The
  parameters after three Adam steps within 1e-5 of max|p| of the JAX
  trainer's ``step_fn``, at float64: in float32 Adam's first update,
  lr * g / (|g| + eps), turns gradients at the float32 noise floor
  (|g| near 1e-8, 1e-7 of max|g|) into steps of +-lr, so two float32 runs
  part by about lr (3.0e-4 of max|p| after three steps, CPU reading of
  tools/torch_train_readings.py) whichever computes them.
* CREPE-tiny's train-mode logits within 1e-5 of max|logits| and its
  running-statistics updates within 1e-5 of their max (float32), its loss
  rtol 1e-5 and gradients 1e-4 of max|g| (float32), two optax steps
  within 1e-5 of max|p| (float64, as above); the cosine schedule within
  1e-7 of the initial rate of optax's at every count of a 20-step run.
* Checkpoints: a 2-step port FCNF0 checkpoint gives the port's logits
  through the JAX package's ``fcnf0_forward`` within 1e-5 of max; a
  2-step CREPE checkpoint the same through ``crepe_forward``.
"""

from __future__ import annotations

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffsptk_tpu.ops import pitch_nn as jnn
from diffsptk_tpu_torch.kernels import threefry
from diffsptk_tpu_torch.ops import pitch_nn as tnn
from diffsptk_tpu_torch.utils import prng

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JF = _load("train_fcnf0")
JC = _load("train_crepe_tiny")
TF = _load("torch_train_fcnf0")
TC = _load("torch_train_crepe_tiny")

LR = 2e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_tree(got: dict, want: dict) -> float:
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    return max(float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
               for k in want) / scale


# ------------------------------------------------------------ the corpora
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("jax_mod,port_mod", [(JF, TF), (JC, TC)],
                         ids=["fcnf0", "crepe"])
def test_numpy_corpus_equals_jax(jax_mod, port_mod, seed):
    want = jax_mod.synth_batch(np.random.default_rng(seed), 3)
    got = port_mod.synth_batch(np.random.default_rng(seed), 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


RANGES = [(0, 4), (0, 3), (-5, 7), (10, 10), (10, 3), (0, 1000003),
          (-2 ** 31, 2 ** 31 - 1), (-100, 2 ** 31)]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed,shape", [(0, (7,)), (3, (3, 5)),
                                        (99, (1000,))])
def test_randint_equals_jax(seed, shape, dtype):
    """Bit for bit, with JAX's clipping of the bounds, its span of 1 for
    an empty range and one more for a maximum above the type's; int64
    draws 64-bit words (and reaches spans past 2^62)."""
    jd = jnp.int32 if dtype == torch.int32 else jnp.int64
    ranges = RANGES + ([(0, 2 ** 40 + 7), (-2 ** 62, 2 ** 62 + 5),
                        (-2 ** 63, 2 ** 63 - 1), (0, 2 ** 63 - 3)]
                       if dtype == torch.int64 else [])
    for lo, hi in ranges:
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                             lo, hi, jd))
        got = prng.randint(prng.PRNGKey(seed), shape, lo, hi, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{lo, hi}")
        on_host = threefry.randint(prng.PRNGKey(seed), shape, lo, hi, dtype,
                                   "cpu")
        assert torch.equal(on_host, got)


@pytest.mark.parametrize("bounds", [(math.log(41.0), math.log(1300.0)),
                                    (-0.02, 0.02), (60.0, 500.0),
                                    (0.03, 1.0), (-1.0, 2.0)])
def test_float32_uniform_with_bounds_equals_jax(bounds):
    """The scale and shift are one fused multiply-add, as XLA fuses them:
    equal bit for bit (two roundings differed on up to half the draws)."""
    for seed in (0, 5):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), (20001,), jnp.float32, *bounds))
        got = prng.uniform(prng.PRNGKey(seed), (20001,), torch.float32,
                           *bounds)
        np.testing.assert_array_equal(got.numpy(), want)


SEEDS = (0, 3)
B_DEVICE = 3


@pytest.fixture(scope="module")
def jax_device_corpus():
    """The JAX trainer's device corpus for SEEDS: under x64 (float64
    inside, float32 out) and with x64 off (float32)."""
    fn = jax.jit(JF.synth_batch_device, static_argnums=1)
    out = {}
    for seed in SEEDS:
        out[seed, 64] = [np.asarray(a) for a in fn(jax.random.PRNGKey(seed),
                                                   B_DEVICE)]
    with jax.enable_x64(False):
        fn32 = jax.jit(JF.synth_batch_device, static_argnums=1)
        for seed in SEEDS:
            out[seed, 32] = [np.asarray(a) for a in fn32(
                jax.random.PRNGKey(seed), B_DEVICE)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_device_corpus_float64_matches_jax(jax_device_corpus, seed):
    x, target = TF.synth_batch_device(prng.PRNGKey(seed), B_DEVICE, "cpu",
                                      torch.float64)
    assert x.dtype == target.dtype == torch.float64
    want_x, want_t = jax_device_corpus[seed, 64]
    np.testing.assert_allclose(x.numpy(), want_x, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(target.numpy(), want_t, rtol=1e-5, atol=1e-8)


def _jax_draws(seed: int, B: int) -> dict:
    """The JAX trainer's draws (tools/train_fcnf0.py:113-189), float32."""
    W, K, C = JF.PENN_WINDOW_SIZE, 48, 8

    def draws(key):
        ks = jax.random.split(key, 16)
        u = jax.random.uniform
        return {
            "f0": u(ks[0], (B,), minval=math.log(41.0),
                    maxval=math.log(1300.0)),
            "drift": u(ks[1], (B,), minval=-0.02, maxval=0.02),
            "vib_depth": u(ks[12], (B, 1), minval=0.0, maxval=0.15),
            "vib_rate": u(ks[13], (B, 1), minval=math.log(0.5),
                          maxval=math.log(8.0)),
            "vib_phase": u(ks[14], (B, 1), maxval=2 * jnp.pi),
            "rolloff": u(ks[2], (B, 1), minval=0.3, maxval=2.5),
            "n_formants": jax.random.randint(ks[3], (B,), 0, 4),
            "fc": u(ks[4], (B, 3), minval=math.log(150.0),
                    maxval=math.log(3000.0)),
            "bw": u(ks[5], (B, 3), minval=60.0, maxval=500.0),
            "gain": u(ks[6], (B, 3), minval=0.0, maxval=8.0),
            "cep": jax.random.normal(ks[15], (B, C)),
            "phases0": u(ks[7], (B, K), maxval=2 * jnp.pi),
            "snr_db": u(ks[8], (B,), minval=0.0, maxval=40.0),
            "noise": jax.random.normal(ks[9], (B, W)),
            "unvoiced": u(ks[10], (B,)),
            "level": u(ks[11], (B, 1), minval=0.03, maxval=1.0),
        }

    with jax.enable_x64(False):
        d = jax.jit(draws)(jax.random.PRNGKey(seed))
        return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_device_corpus_float32_draws_equal_jax(seed):
    got = TF.corpus_draws(prng.PRNGKey(seed), 64, "cpu", torch.float32)
    want = _jax_draws(seed, 64)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _float64_on(draws: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v
            for k, v in draws.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_device_corpus_within_bars_of_float64(jax_device_corpus,
                                                     seed):
    """The port's float32 corpus, and JAX's, against float64 arithmetic on
    the same float32 draws: within ``CORPUS32_BARS``."""
    draws = TF.corpus_draws(prng.PRNGKey(seed), B_DEVICE, "cpu",
                            torch.float32)
    x32, t32 = TF.synth_from_draws(draws)
    assert x32.dtype == t32.dtype == torch.float32
    x64, t64 = (a.numpy() for a in TF.synth_from_draws(_float64_on(draws)))
    bars = TF.CORPUS32_BARS
    assert _rel(x32.numpy(), x64) <= bars["x"]
    assert _rel(t32.numpy(), t64) <= bars["target"]
    jx, jt = jax_device_corpus[seed, 32]
    assert _rel(jx, x64) <= bars["x"]
    assert _rel(jt, t64) <= bars["target"]


# ------------------------------------------------------------- FCNF0 steps
def _jax_fcnf0_loss(p, x, target):
    """The JAX trainer's ``loss_fn`` (tools/train_fcnf0.py:209-212)."""
    logits = jnn.fcnf0_forward(p, x)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.sum(target * logp, axis=-1))


@jax.jit
def _jax_fcnf0_step(p, m, v, x, target, t):
    """The JAX trainer's ``step_fn`` (tools/train_fcnf0.py:221-240)."""
    loss, grads = jax.value_and_grad(_jax_fcnf0_loss)(p, x, target)
    b1, b2, eps = 0.9, 0.999, 1e-8
    new_p, new_m, new_v = {}, {}, {}
    for k in p:
        g = grads[k]
        new_m[k] = b1 * m[k] + (1 - b1) * g
        new_v[k] = b2 * v[k] + (1 - b2) * g * g
        mhat = new_m[k] / (1 - b1 ** t)
        vhat = new_v[k] / (1 - b2 ** t)
        new_p[k] = p[k] - LR * mhat / (jnp.sqrt(vhat) + eps)
    return new_p, new_m, new_v, loss


def _fcnf0_batches(n: int, B: int = 2):
    rng = np.random.default_rng(1)
    return [JF.synth_batch(rng, B) for _ in range(n)]


@pytest.fixture(scope="module")
def fcnf0_ref():
    """JAX's loss and gradients (float32) at the initial and at the
    bundled parameters on one batch, and its parameters after three
    ``step_fn`` steps at float64."""
    init = jnn.init_fcnf0_params(0)
    bundled = dict(np.load(tnn.bundled_weights_path("fcnf0_synth.npz")))
    batches = _fcnf0_batches(3)
    x, target = (jnp.asarray(a) for a in batches[0])
    vg = jax.jit(jax.value_and_grad(_jax_fcnf0_loss))
    out = {"batches": batches, "init": init, "bundled": bundled}
    for name in ("init", "bundled"):
        loss, grads = vg({k: jnp.asarray(v) for k, v in out[name].items()},
                         x, target)
        out[name + "_loss"] = float(loss)
        out[name + "_grads"] = {k: np.asarray(g) for k, g in grads.items()}
    p = {k: jnp.asarray(v, jnp.float64) for k, v in init.items()}
    m = {k: jnp.zeros_like(v) for k, v in p.items()}
    v = {k: jnp.zeros_like(a) for k, a in p.items()}
    for t, (xb, tb) in enumerate(batches, start=1):
        p, m, v, _ = _jax_fcnf0_step(p, m, v, jnp.asarray(xb, jnp.float64),
                                     jnp.asarray(tb, jnp.float64), t)
    out["after3"] = {k: np.asarray(a) for k, a in p.items()}
    return out


def test_fcnf0_loss_and_grads_match_jax(fcnf0_ref):
    x, target = (torch.as_tensor(a) for a in fcnf0_ref["batches"][0])
    for name in ("init", "bundled"):
        trainer = TF.Trainer(fcnf0_ref[name], "cpu")
        assert all(p.dtype == torch.float32 and p.requires_grad and p.is_leaf
                   for p in trainer.params.values())
        loss, grads = trainer.loss_and_grads(x, target)
        assert math.isclose(float(loss), fcnf0_ref[name + "_loss"],
                            rel_tol=1e-5)
        if name == "init":
            got = dict(zip(trainer.params, (g.numpy() for g in grads)))
            assert _rel_tree(got, fcnf0_ref["init_grads"]) <= 1e-4


def test_fcnf0_three_adam_steps_match_jax(fcnf0_ref):
    trainer = TF.Trainer(fcnf0_ref["init"], "cpu", dtype=torch.float64)
    for xb, tb in fcnf0_ref["batches"]:
        trainer.step(torch.as_tensor(xb, dtype=torch.float64),
                     torch.as_tensor(tb, dtype=torch.float64))
    assert trainer.adam.count == 3
    assert _rel_tree(trainer.numpy_params(), fcnf0_ref["after3"]) <= 1e-5


def test_fcnf0_checkpoint_loads_in_jax(tmp_path, capsys):
    """Two CPU steps of the port's trainer (numpy corpus, full fp32), its
    npz through the JAX package's forward: the port's logits within 1e-5
    of max."""
    out = tmp_path / "fcnf0.npz"
    TF.main(["--device", "cpu", "--steps", "2", "--batch", "2",
             "--eval-frames", "4", "--log-every", "1", "--out", str(out)])
    assert "RPA50" in capsys.readouterr().out
    params = dict(np.load(out))
    assert set(params) == set(tnn.fcnf0_shapes())
    init = jnn.init_fcnf0_params(0)
    assert max(float(np.abs(params[k] - init[k]).max()) for k in init) > 0
    x = JF.synth_batch(np.random.default_rng(5), 3)[0]
    want = np.asarray(jax.jit(jnn.fcnf0_forward)(params, jnp.asarray(x)))
    got = tnn.fcnf0_forward({k: torch.as_tensor(v) for k, v in
                             params.items()}, torch.as_tensor(x))
    assert _rel(got.numpy(), want) <= 1e-5


# ------------------------------------------------------------- CREPE steps
CREPE_STEPS = 20


def _jax_crepe_loss(tp, params, x, y):
    """The JAX trainer's loss (tools/train_crepe_tiny.py:187-201)."""
    p = dict(params)
    p.update(tp)
    logits, updates = JC.crepe_train_logits(p, x)
    return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, y)), (
        logits, updates)


def _crepe_batches(n: int, B: int = 4):
    rng = np.random.default_rng(2)
    return [JC.synth_batch(rng, B) for _ in range(n)]


@pytest.fixture(scope="module")
def crepe_ref():
    """JAX's train-mode logits, updates, loss and gradients at float32 on
    one batch, and the parameters after two optax steps at float64."""
    init = jnn.init_crepe_params("tiny", seed=0)
    trainable = [k for k in init if "running_" not in k]
    batches = _crepe_batches(2)
    vg = jax.jit(jax.value_and_grad(_jax_crepe_loss, has_aux=True))
    x, y = (jnp.asarray(a) for a in batches[0])
    (loss, (logits, updates)), grads = vg(
        {k: jnp.asarray(init[k]) for k in trainable},
        {k: jnp.asarray(v) for k, v in init.items()}, x, y)
    out = {"init": init, "batches": batches, "loss": float(loss),
           "logits": np.asarray(logits),
           "updates": {k: np.asarray(v) for k, v in updates.items()},
           "grads": {k: np.asarray(g) for k, g in grads.items()}}
    params = {k: jnp.asarray(v, jnp.float64) for k, v in init.items()}
    opt = optax.adam(optax.cosine_decay_schedule(LR, CREPE_STEPS, 0.05))
    state = opt.init({k: params[k] for k in trainable})

    @jax.jit
    def update(tp, g, state):
        u, state = opt.update(g, state)
        return optax.apply_updates(tp, u), state

    for xb, yb in batches:
        tp = {k: params[k] for k in trainable}
        (_, (_, upd)), g = vg(tp, params, jnp.asarray(xb, jnp.float64),
                              jnp.asarray(yb, jnp.float64))
        tp, state = update(tp, g, state)
        params = dict(params)
        params.update(tp)
        params.update(upd)
    out["after2"] = {k: np.asarray(v) for k, v in params.items()}
    return out


def test_crepe_train_forward_and_grads_match_jax(crepe_ref):
    x, y = (torch.as_tensor(a) for a in crepe_ref["batches"][0])
    trainer = TC.Trainer(crepe_ref["init"], "cpu", LR, CREPE_STEPS)
    assert trainer.trainable == [k for k in crepe_ref["init"]
                                 if "running_" not in k]
    logits, updates = TC.crepe_train_logits(trainer.params, x)
    assert _rel(logits.detach().numpy(), crepe_ref["logits"]) <= 1e-5
    assert set(updates) == set(crepe_ref["updates"])
    assert all(not u.requires_grad for u in updates.values())
    assert _rel_tree({k: u.numpy() for k, u in updates.items()},
                     crepe_ref["updates"]) <= 1e-5
    loss, grads, _ = trainer.loss_and_grads(x, y)
    assert math.isclose(float(loss), crepe_ref["loss"], rel_tol=1e-5)
    got = dict(zip(trainer.trainable, (g.numpy() for g in grads)))
    assert _rel_tree(got, crepe_ref["grads"]) <= 1e-4


def test_crepe_two_optax_steps_match_jax(crepe_ref):
    trainer = TC.Trainer(crepe_ref["init"], "cpu", LR, CREPE_STEPS,
                         dtype=torch.float64)
    for xb, yb in crepe_ref["batches"]:
        trainer.step(torch.as_tensor(xb, dtype=torch.float64),
                     torch.as_tensor(yb, dtype=torch.float64))
    got = trainer.numpy_params()
    assert _rel_tree(got, crepe_ref["after2"]) <= 1e-5
    running = {k: v for k, v in crepe_ref["after2"].items()
               if "running_" in k}
    assert _rel_tree(got, running) <= 1e-5


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(LR, CREPE_STEPS, 0.05)
    got = TC.cosine_decay(LR, CREPE_STEPS, 0.05)
    for count in range(CREPE_STEPS + 3):
        assert abs(got(count) - float(want(count))) <= 1e-7 * LR, count


def test_crepe_checkpoint_round_trip(tmp_path, capsys):
    """Two CPU steps of the port's trainer; the npz (running statistics
    moved, the rest trained) through the JAX package's ``crepe_forward``
    gives the port's probabilities within 1e-5 of max, and the port's
    extractor takes it."""
    out = tmp_path / "crepe.npz"
    TC.main(["--device", "cpu", "--steps", "2", "--batch", "4",
             "--eval-frames", "8", "--log-every", "1", "--out", str(out)])
    assert "RPA50" in capsys.readouterr().out
    params = dict(np.load(out))
    init = jnn.init_crepe_params("tiny", seed=0)
    assert set(params) == set(init)
    assert float(np.abs(params["conv1_BN.running_mean"]).max()) > 0
    x = JC.synth_batch(np.random.default_rng(5), 3)[0]
    want = np.asarray(jax.jit(jnn.crepe_forward, static_argnums=2)(
        params, jnp.asarray(x), "tiny"))
    got = tnn.crepe_forward(params, torch.as_tensor(x), "tiny")
    assert _rel(got.numpy(), want) <= 1e-5
    ext = tnn.PitchExtractionByCREPE(80, 16000, model="tiny",
                                     weights=str(out), device="cpu")
    assert torch.equal(ext.params["conv3.weight"],
                       torch.as_tensor(params["conv3.weight"]))
