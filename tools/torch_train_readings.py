#!/usr/bin/env python3
"""CPU readings behind the training bars, the port beside the JAX package.

    JAX_PLATFORMS=cpu python3 tools/torch_train_readings.py

1. The FCNF0 device corpus in float32 against float64 arithmetic on the
   same float32 draws (``tools/torch_train_fcnf0.py:CORPUS32_BARS`` is ten
   times the port's largest reading): the port's corpus and the JAX
   trainer's (``tools/train_fcnf0.py:synth_batch_device`` with x64 off),
   each output's largest distance over its max, for six seeds of 64
   frames.
2. Three FCNF0 Adam steps from ``init_fcnf0_params(0)`` on the JAX
   trainer's numpy batches (batch 2), the port against the JAX trainer's
   step, in float32 and in float64: the parameters' largest distance over
   max|p|, and the first step's gradients' over max|g|.

It imports JAX (the reference), as the tests do; nothing of it runs on a
card.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

LR = 2e-4


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from diffsptk_tpu.ops.pitch_nn import fcnf0_forward, init_fcnf0_params
    from diffsptk_tpu_torch.utils import prng

    JF, TF = _load("train_fcnf0"), _load("torch_train_fcnf0")

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    fn32 = jax.jit(JF.synth_batch_device, static_argnums=1)
    port, ref = {"x": [], "target": []}, {"x": [], "target": []}
    for seed in range(6):
        draws = TF.corpus_draws(prng.PRNGKey(seed), 64, "cpu")
        out32 = TF.synth_from_draws(draws)
        out64 = TF.synth_from_draws(
            {k: v.double() if v.is_floating_point() else v
             for k, v in draws.items()})
        jout = fn32(jax.random.PRNGKey(seed), 64)
        for i, name in enumerate(("x", "target")):
            port[name].append(rel(out32[i].numpy(), out64[i].numpy()))
            ref[name].append(rel(jout[i], out64[i].numpy()))
    for name in ("x", "target"):
        print(f"corpus {name}: float32 from float64 on the same draws, of "
              f"max: port {max(port[name]):.3e} (seeds "
              + ", ".join(f"{v:.2e}" for v in port[name])
              + f"), JAX package {max(ref[name]):.3e}", flush=True)

    jax.config.update("jax_enable_x64", True)

    def loss_fn(p, x, target):
        logp = jax.nn.log_softmax(fcnf0_forward(p, x), axis=-1)
        return -jnp.mean(jnp.sum(target * logp, axis=-1))

    @jax.jit
    def step_fn(p, m, v, x, target, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, target)
        b1, b2, eps = 0.9, 0.999, 1e-8
        new_p, new_m, new_v = {}, {}, {}
        for k in p:
            g = grads[k]
            new_m[k] = b1 * m[k] + (1 - b1) * g
            new_v[k] = b2 * v[k] + (1 - b2) * g * g
            mhat = new_m[k] / (1 - b1 ** t)
            vhat = new_v[k] / (1 - b2 ** t)
            new_p[k] = p[k] - LR * mhat / (jnp.sqrt(vhat) + eps)
        return new_p, new_m, new_v, grads

    init = init_fcnf0_params(0)
    rng = np.random.default_rng(1)
    batches = [JF.synth_batch(rng, 2) for _ in range(3)]
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        p = {k: jnp.asarray(v, jd) for k, v in init.items()}
        m = {k: jnp.zeros_like(v) for k, v in p.items()}
        v = {k: jnp.zeros_like(a) for k, a in p.items()}
        trainer = TF.Trainer(init, "cpu", dtype=td)
        first = None
        for t, (xb, tb) in enumerate(batches, start=1):
            x, target = jnp.asarray(xb, jd), jnp.asarray(tb, jd)
            _, grads = trainer.loss_and_grads(
                torch.as_tensor(np.array(x)),
                torch.as_tensor(np.array(target)))
            p, m, v, jgrads = step_fn(p, m, v, x, target, t)
            if first is None:
                scale = max(float(jnp.abs(g).max()) for g in jgrads.values())
                first = max(float(np.abs(g.numpy()
                                         - np.asarray(jgrads[k])).max())
                            for k, g in zip(trainer.params, grads)) / scale
            trainer.adam.update(grads)
        got = trainer.numpy_params()
        scale = max(float(jnp.abs(a).max()) for a in p.values())
        dist = max(float(np.abs(got[k] - np.asarray(a)).max())
                   for k, a in p.items()) / scale
        print(f"FCNF0 {np.dtype(jd).name}: first step's gradients "
              f"{first:.3e} of max|g|; parameters after three Adam steps "
              f"{dist:.3e} of max|p|", flush=True)


if __name__ == "__main__":
    main()
