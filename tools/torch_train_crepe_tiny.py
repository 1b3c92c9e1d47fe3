"""Train CREPE-tiny on synthetic pitched audio with the PyTorch port: the
counterpart of ``tools/train_crepe_tiny.py`` (see its docstring for the
corpus, the targets and the loss).

The train-mode forward (:func:`crepe_train_logits`) normalises each
layer by the batch's mean and biased variance and moves the running
statistics at momentum 0.1 from the unbiased variance, as the JAX
trainer's does; the running statistics are buffers, never trained.  The
loss is the per-bin sigmoid binary cross-entropy, and the update
``optax.adam`` under ``optax.cosine_decay_schedule(lr, steps, 0.05)``,
written out (the trainer's :class:`Adam`, with the schedule at the update
count before the increment, as optax counts).  The numpy corpus
(:func:`synth_batch`) is made on the host every step, as in the JAX
trainer.  The network runs at ``PitchExtractionByCREPE.PRECISION`` (full
fp32), its backward too.

Checkpoints are ``np.savez`` files under the JAX package's names, running
statistics included, so either package loads the other's.  The default
``--out`` lies under ``checkpoints/``, which git ignores.

Run:  python tools/torch_train_crepe_tiny.py [--steps N] [--batch B]
          [--out F] [--resume F] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from diffsptk_tpu_torch.core import resolve_device  # noqa: E402
from diffsptk_tpu_torch.ops.pitch_nn import (  # noqa: E402
    _CREPE_BN_EPS,
    _CREPE_CAPACITY,
    _CREPE_PADS,
    _CREPE_STRIDES,
    CREPE_CENTS_OFFSET,
    CREPE_CENTS_PER_BIN,
    CREPE_PITCH_BINS,
    CREPE_WINDOW_SIZE,
    PitchExtractionByCREPE,
    conv,
    crepe_forward,
    crepe_shapes,
    init_crepe_params,
    load_params,
    network_precision,
)
from torch_train_fcnf0 import Adam  # noqa: E402

SR = 16000
TARGET_STD_CENTS = 25.0  # CREPE paper, section 2
DEFAULT_OUT = os.path.join(ROOT, "checkpoints", "crepe_tiny_synth_torch.npz")


# ------------------------------------------------------------ data synth
def synth_batch(rng: np.random.Generator, batch: int):
    """(frames (B, 1024) float32 normalized, targets (B, 360) float32)."""
    B, W = batch, CREPE_WINDOW_SIZE
    t = np.arange(W) / SR

    f0 = np.exp(rng.uniform(np.log(50.0), np.log(1500.0), B))
    drift = rng.uniform(-0.02, 0.02, B)
    # in-frame vibrato (natural/vocoded speech sweeps f0 within the
    # 64 ms window; see tools/train_fcnf0.py and
    # tests/test_pitch_speech.py)
    vib_depth = rng.uniform(0.0, 0.15, (B, 1))
    vib_rate = np.exp(rng.uniform(np.log(0.5), np.log(8.0), (B, 1)))
    vib_phase = rng.uniform(0, 2 * np.pi, (B, 1))
    tc = t[None, :] - 0.5 * W / SR
    vib = 2.0 ** (vib_depth * np.sin(2 * np.pi * vib_rate * tc + vib_phase))
    inst_f0 = f0[:, None] * (1 + drift[:, None] * (t[None, :] * SR / W))
    inst_f0 = inst_f0 * vib / vib.mean(axis=1, keepdims=True)
    phase = 2 * np.pi * np.cumsum(inst_f0, axis=1) / SR

    K = 30
    k = np.arange(1, K + 1)
    rolloff = k[None, :] ** -rng.uniform(0.3, 2.5, (B, 1))
    env = rolloff.copy()
    n_formants = rng.integers(0, 4, B)
    fc = np.exp(rng.uniform(np.log(200.0), np.log(4000.0), (B, 3)))
    bw = rng.uniform(80.0, 600.0, (B, 3))
    gain = rng.uniform(0.0, 8.0, (B, 3))
    hfreq = f0[:, None] * k[None, :]
    for j in range(3):
        active = (n_formants > j)[:, None]
        bump = gain[:, j:j + 1] * np.exp(
            -0.5 * ((hfreq - fc[:, j:j + 1]) / bw[:, j:j + 1]) ** 2)
        env = env * np.where(active, 1 + bump, 1.0)
    # smooth cepstral spectral coloration (speech-envelope-like)
    C = 8
    cep = rng.standard_normal((B, C)) * (0.8 / np.arange(1, C + 1))
    ang = np.pi * hfreq / (SR / 2)
    env = env * np.exp(np.einsum(
        "bc,bkc->bk", cep, np.cos(ang[:, :, None] * np.arange(1, C + 1))))
    env = env * (hfreq < SR / 2 - 200)         # anti-alias

    phases0 = rng.uniform(0, 2 * np.pi, (B, K))
    x = np.einsum("bk,bkt->bt", env,
                  np.sin(k[None, :, None] * phase[:, None, :]
                         + phases0[:, :, None]))
    x = x / np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-9)

    snr_db = rng.uniform(0.0, 40.0, B)
    sig_pow = np.mean(x ** 2, axis=1)
    noise_pow = sig_pow / 10 ** (snr_db / 10)
    x = x + rng.standard_normal((B, W)) * np.sqrt(noise_pow)[:, None]

    cents = 1200 * np.log2(f0 / 10.0)
    bins = (cents - CREPE_CENTS_OFFSET) / CREPE_CENTS_PER_BIN
    bc = np.arange(CREPE_PITCH_BINS)
    target = np.exp(-0.5 * ((bc[None, :] - bins[:, None])
                            * CREPE_CENTS_PER_BIN / TARGET_STD_CENTS) ** 2)

    unvoiced = rng.random(B) < 0.10
    x[unvoiced] = rng.standard_normal((int(unvoiced.sum()), W))
    target[unvoiced] = 0.0

    x = x - x.mean(axis=1, keepdims=True)
    x = x / np.maximum(x.std(axis=1, keepdims=True), 1e-10)
    return x.astype(np.float32), target.astype(np.float32)


# ------------------------------------------------- train-mode forward/BN
def crepe_train_logits(params: dict, x: torch.Tensor, model: str = "tiny",
                       momentum: float = 0.1, precision: str = "full"):
    """Forward with batch-statistics BatchNorm; returns (logits, updates),
    where ``updates`` maps the running statistics' names to their new
    moving averages (detached).  Each layer: pad, conv (``precision`` as
    for ``ops/pitch_nn.conv``), ReLU, BatchNorm on the batch's mean and
    biased variance, max-pool 2 (ties share the gradient, as JAX's max
    reduction shares it); then the classifier
    (``tools/train_crepe_tiny.py:125-158``)."""
    cap = _CREPE_CAPACITY[model]
    h = x[:, None, :]
    updates = {}
    for i in range(1, 7):
        h = F.pad(h, _CREPE_PADS[i - 1])
        h = conv(h, params[f"conv{i}.weight"], params[f"conv{i}.bias"],
                 stride=_CREPE_STRIDES[i - 1], precision=precision)
        h = torch.relu(h)
        var, mean = torch.var_mean(h, dim=(0, 2), correction=0)
        n = h.shape[0] * h.shape[2]
        with torch.no_grad():
            unbiased = var * n / max(n - 1, 1)
            bn = f"conv{i}_BN"
            updates[f"{bn}.running_mean"] = (
                (1 - momentum) * params[f"{bn}.running_mean"]
                + momentum * mean)
            updates[f"{bn}.running_var"] = (
                (1 - momentum) * params[f"{bn}.running_var"]
                + momentum * unbiased)
        h = ((h - mean[None, :, None])
             * torch.rsqrt(var + _CREPE_BN_EPS)[None, :, None]
             * params[f"conv{i}_BN.weight"][None, :, None]
             + params[f"conv{i}_BN.bias"][None, :, None])
        B, C, T = h.shape
        h = torch.amax(h[:, :, :T - T % 2].reshape(B, C, T // 2, 2), dim=-1)
    h = h.transpose(1, 2).reshape(h.shape[0], cap["in_features"])
    with network_precision(precision):
        logits = h @ params["classifier.weight"].T + params["classifier.bias"]
    return logits, updates


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` written out:
    relu(z) - z y + log1p(exp(-|z|)), elementwise."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)``: the
    learning rate at an update count, on the host."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        decayed = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * decayed + alpha)

    return schedule


class Trainer:
    """CREPE's parameters on ``device``: the trained ones (every name
    without ``running_``) as float32 leaves that require gradients, the
    running statistics as plain tensors, with the Adam state.  They are
    float32, as the JAX trainer's; ``dtype=torch.float64`` serves
    comparisons."""

    def __init__(self, params: dict, device=None, lr: float = 2e-4,
                 steps: int = 20000, model: str = "tiny",
                 precision: str | None = None,
                 dtype=torch.float32) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.precision = (PitchExtractionByCREPE.PRECISION
                          if precision is None else precision)
        self.params = {}
        for k in crepe_shapes(model):
            trained = "running_" not in k
            self.params[k] = torch.tensor(
                np.asarray(params[k]), dtype=dtype,
                device=self.device, requires_grad=trained)
        self.trainable = [k for k in self.params if "running_" not in k]
        self.adam = Adam([self.params[k] for k in self.trainable],
                         cosine_decay(lr, steps, 0.05))

    def loss_and_grads(self, x: torch.Tensor, y: torch.Tensor):
        """The loss (a 0-d tensor on the device), the gradients in
        ``trainable``'s order and the running statistics' updates."""
        with network_precision(self.precision):
            logits, updates = crepe_train_logits(
                self.params, x, self.model, precision=self.precision)
            loss = torch.mean(sigmoid_bce(logits, y))
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in self.trainable])
        return loss.detach(), grads, updates

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, grads, updates = self.loss_and_grads(x, y)
        self.adam.update(grads)
        with torch.no_grad():
            for k, value in updates.items():
                self.params[k].copy_(value)
        return loss

    def numpy_params(self) -> dict:
        return {k: p.detach().cpu().numpy() for k, p in self.params.items()}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **self.numpy_params())

    @torch.no_grad()
    def evaluate(self, n: int = 512):
        """``evaluate`` (``tools/train_crepe_tiny.py:212-228``) through the
        port's eval-mode ``crepe_forward``: RPA50 over the voiced frames
        of a fixed numpy batch, and the mean confidence voiced and
        unvoiced."""
        x, y = synth_batch(np.random.default_rng(12345), n)
        voiced = y.max(axis=1) > 0.5
        probs = crepe_forward(self.params, torch.as_tensor(
            x, device=self.device), self.model,
            precision=self.precision).cpu().numpy()
        err_cents = np.abs(probs.argmax(axis=1) - y.argmax(axis=1)) \
            * CREPE_CENTS_PER_BIN
        rpa50 = float((err_cents[voiced] <= 50).mean())
        conf_v = float(probs.max(axis=1)[voiced].mean())
        conf_u = (float(probs.max(axis=1)[~voiced].mean())
                  if (~voiced).any() else 0.0)
        return rpa50, conf_v, conf_u


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--log-every", type=int, default=500,
                    help="steps between the loss reads, evals and "
                         "checkpoints (and after the first step)")
    ap.add_argument("--eval-frames", type=int, default=512)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.resume:
        params = load_params(args.resume, None, expect=crepe_shapes("tiny"))
        print(f"resumed from {args.resume}")
    else:
        params = init_crepe_params("tiny", seed=args.seed)
    trainer = Trainer(params, device, args.lr, args.steps)

    t0 = time.time()
    for it in range(1, args.steps + 1):
        x, y = (torch.as_tensor(a, device=device)
                for a in synth_batch(rng, args.batch))
        loss = trainer.step(x, y)
        if it % args.log_every == 0 or it == 1:
            rpa, cv, cu = trainer.evaluate(args.eval_frames)
            rate = it * args.batch / (time.time() - t0)
            print(f"step {it:6d} loss {float(loss):.4f} "
                  f"RPA50 {rpa:.3f} conf_v {cv:.2f} conf_u {cu:.2f} "
                  f"({rate:.0f} frames/s)", flush=True)
            trainer.save(args.out)
    trainer.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
