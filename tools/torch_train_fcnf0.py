"""Train FCNF0++ on synthetic pitched audio with the PyTorch port: the
counterpart of ``tools/train_fcnf0.py`` (see its docstring for the corpus
and the loss).

The network, its loss and its Adam step are the JAX trainer's.  On the
card (the default) every step draws its batch there from JAX's threefry
streams (:func:`synth_batch_device`: the JAX trainer's device corpus, with
the same keys and, at float32, the same draws bit for bit, through the
threefry kernel), runs the network at ``PitchExtractionByFCNF0.PRECISION``
(TF32) and reads nothing back to the host but the loss once every
``--log-every`` steps.  With ``--device cpu`` it draws the numpy corpus
(:func:`synth_batch`) from the JAX trainer's CPU generator and runs in full
fp32, so both trainers take the same steps.

The backward runs inside ``network_precision(precision)``: in TF32 every
convolution's gradients may take TF32 (the first layer's too, whose forward
stays in fp32); in full fp32 none does.

Checkpoints are ``np.savez`` files under the JAX package's parameter
names, so either package loads the other's; ``--resume`` takes one (the
JAX package's ``diffsptk_tpu/assets/fcnf0_synth.npz``, say).  The default
``--out`` lies under ``checkpoints/``, which git ignores.

Run:  python tools/torch_train_fcnf0.py [--steps N] [--batch B] [--out F]
          [--resume F] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffsptk_tpu_torch.core import resolve_device  # noqa: E402
from diffsptk_tpu_torch.kernels import threefry  # noqa: E402
from diffsptk_tpu_torch.ops.pitch_nn import (  # noqa: E402
    PENN_CENTS_PER_BIN,
    PENN_FMIN,
    PENN_PITCH_BINS,
    PENN_SAMPLE_RATE,
    PENN_WINDOW_SIZE,
    PitchExtractionByFCNF0,
    fcnf0_forward,
    fcnf0_shapes,
    init_fcnf0_params,
    load_params,
    network_precision,
)
from diffsptk_tpu_torch.utils import prng  # noqa: E402

TARGET_STD_CENTS = 25.0
DEFAULT_OUT = os.path.join(ROOT, "checkpoints", "fcnf0_synth_torch.npz")


# ------------------------------------------------------------ data synth
def synth_batch(rng: np.random.Generator, batch: int):
    """(frames (B, 1024) float32, targets (B, 1440) float32 summing to 1)."""
    B, W, SR = batch, PENN_WINDOW_SIZE, PENN_SAMPLE_RATE
    t = np.arange(W) / SR

    f0 = np.exp(rng.uniform(np.log(41.0), np.log(1300.0), B))
    drift = rng.uniform(-0.02, 0.02, B)
    inst_f0 = f0[:, None] * (1 + drift[:, None] * (t[None, :] * SR / W))
    phase = 2 * np.pi * np.cumsum(inst_f0, axis=1) / SR

    K = 24
    k = np.arange(1, K + 1)
    rolloff = k[None, :] ** -rng.uniform(0.3, 2.5, (B, 1))
    env = rolloff.copy()
    n_formants = rng.integers(0, 4, B)
    fc = np.exp(rng.uniform(np.log(150.0), np.log(3000.0), (B, 3)))
    bw = rng.uniform(60.0, 500.0, (B, 3))
    gain = rng.uniform(0.0, 8.0, (B, 3))
    hfreq = f0[:, None] * k[None, :]
    for j in range(3):
        active = (n_formants > j)[:, None]
        bump = gain[:, j:j + 1] * np.exp(
            -0.5 * ((hfreq - fc[:, j:j + 1]) / bw[:, j:j + 1]) ** 2)
        env = env * np.where(active, 1 + bump, 1.0)
    env = env * (hfreq < SR / 2 - 150)          # anti-alias

    phases0 = rng.uniform(0, 2 * np.pi, (B, K))
    x = np.einsum("bk,bkt->bt", env,
                  np.sin(k[None, :, None] * phase[:, None, :]
                         + phases0[:, :, None]))
    x = x / np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-9)

    snr_db = rng.uniform(0.0, 40.0, B)
    sig_pow = np.mean(x ** 2, axis=1)
    noise_pow = sig_pow / 10 ** (snr_db / 10)
    x = x + rng.standard_normal((B, W)) * np.sqrt(noise_pow)[:, None]

    bins = 1200 * np.log2(f0 / PENN_FMIN) / PENN_CENTS_PER_BIN
    bc = np.arange(PENN_PITCH_BINS)
    target = np.exp(-0.5 * ((bc[None, :] - bins[:, None])
                            * PENN_CENTS_PER_BIN / TARGET_STD_CENTS) ** 2)

    unvoiced = rng.random(B) < 0.10
    x[unvoiced] = rng.standard_normal((int(unvoiced.sum()), W))
    target[unvoiced] = 1.0                      # -> uniform after norm

    # raw-amplitude input (see module docstring): random per-frame gain
    x = x * rng.uniform(0.03, 1.0, (B, 1))
    target = target / target.sum(axis=1, keepdims=True)
    return x.astype(np.float32), target.astype(np.float32)


DEVICE_HARMONICS = 48
DEVICE_CEPSTRA = 8
CORPUS_LAUNCHES = 17
"""Threefry kernel launches of one float32 device batch on the card: 13
uniform draws, 2 normal draws and randint's 2."""

# The float32 device corpus against float64 arithmetic on the same draws,
# as a share of each output's max: ten times the CPU reading (x 1.08e-4,
# target 1.87e-5 over six seeds of 64 frames; the JAX package's float32
# corpus reads 1.60e-4 and 1.96e-5 there: tools/torch_train_readings.py).
# The phase arguments reach about 5e4 rad, where a float32 ulp is 4e-3.
CORPUS32_BARS = {"x": 1.1e-3, "target": 1.9e-4}


def corpus_draws(key: torch.Tensor, batch: int, device,
                 dtype=torch.float32) -> dict:
    """The random draws of one device batch, each under its key of
    ``prng.split(key, 16)`` as ``tools/train_fcnf0.py:113-189`` draws them:
    through the threefry kernel for a float32 batch on the card (the
    integers int32, two launches), the twin elsewhere (int64 words at
    float64, as JAX's default integer under x64).  ``key`` lies on the
    host, so the kernel takes its words as arguments: no host read."""
    B, W, K, C = batch, PENN_WINDOW_SIZE, DEVICE_HARMONICS, DEVICE_CEPSTRA
    ks = prng.split(key, 16)
    itype = torch.int32 if dtype == torch.float32 else torch.int64

    def uniform(i, shape, minval=0.0, maxval=1.0):
        return threefry.uniform(ks[i], shape, dtype, device, minval, maxval)

    return {
        "f0": uniform(0, (B,), math.log(41.0), math.log(1300.0)),
        "drift": uniform(1, (B,), -0.02, 0.02),
        "vib_depth": uniform(12, (B, 1), 0.0, 0.15),
        "vib_rate": uniform(13, (B, 1), math.log(0.5), math.log(8.0)),
        "vib_phase": uniform(14, (B, 1), maxval=2 * math.pi),
        "rolloff": uniform(2, (B, 1), 0.3, 2.5),
        "n_formants": threefry.randint(ks[3], (B,), 0, 4, itype, device),
        "fc": uniform(4, (B, 3), math.log(150.0), math.log(3000.0)),
        "bw": uniform(5, (B, 3), 60.0, 500.0),
        "gain": uniform(6, (B, 3), 0.0, 8.0),
        "cep": threefry.normal(ks[15], (B, C), dtype, device),
        "phases0": uniform(7, (B, K), maxval=2 * math.pi),
        "snr_db": uniform(8, (B,), 0.0, 40.0),
        "noise": threefry.normal(ks[9], (B, W), dtype, device),
        "unvoiced": uniform(10, (B,)),
        "level": uniform(11, (B, 1), 0.03, 1.0),
    }


def synth_from_draws(d: dict):
    """The batch (frames (B, 1024), targets (B, 1440)) that
    ``tools/train_fcnf0.py:synth_batch_device`` computes from its draws, in
    the draws' dtype and on their device, operation for operation (the
    float32 constants it builds, 0.8 / k among them, are rounded to
    float32 as there)."""
    W, SR, K, C = (PENN_WINDOW_SIZE, PENN_SAMPLE_RATE, DEVICE_HARMONICS,
                   DEVICE_CEPSTRA)
    noise = d["noise"]
    dtype, device = noise.dtype, noise.device

    def arange(start, stop, dt=dtype):
        return torch.arange(start, stop, dtype=dt, device=device)

    t = arange(0, W) / SR
    k = arange(1, K + 1, torch.float32).to(dtype)

    f0 = torch.exp(d["f0"])
    drift = d["drift"]
    vib_depth, vib_phase = d["vib_depth"], d["vib_phase"]
    vib_rate = torch.exp(d["vib_rate"])
    tc = t[None, :] - 0.5 * W / SR
    vib = 2.0 ** (vib_depth * torch.sin(2 * math.pi * vib_rate * tc
                                        + vib_phase)
                  - vib_depth * torch.sin(vib_phase - math.pi * vib_rate
                                          * W / SR))
    inst_f0 = f0[:, None] * (1 + drift[:, None] * (t[None, :] * SR / W))
    inst_f0 = inst_f0 * vib / torch.mean(vib, dim=1, keepdim=True)
    phase = 2 * math.pi * torch.cumsum(inst_f0, dim=1) / SR

    env = k[None, :] ** -d["rolloff"]
    n_formants, fc = d["n_formants"], torch.exp(d["fc"])
    bw, gain = d["bw"], d["gain"]
    hfreq = f0[:, None] * k[None, :]
    for j in range(3):
        active = (n_formants > j)[:, None]
        bump = gain[:, j:j + 1] * torch.exp(
            -0.5 * ((hfreq - fc[:, j:j + 1]) / bw[:, j:j + 1]) ** 2)
        env = env * torch.where(active, 1 + bump, 1.0)
    ck = arange(1, C + 1, torch.float32)
    cep = d["cep"] * (torch.full_like(ck, 0.8) / ck).to(dtype)
    ang = math.pi * hfreq / (SR / 2)
    env = env * torch.exp(torch.einsum(
        "bc,bkc->bk", cep, torch.cos(ang[:, :, None] * ck.to(dtype))))
    env = env * (hfreq < SR / 2 - 150)

    x = torch.einsum("bk,bkt->bt", env,
                     torch.sin(k[None, :, None] * phase[:, None, :]
                               + d["phases0"][:, :, None]))
    x = x / torch.clamp(torch.amax(torch.abs(x), dim=1, keepdim=True),
                        min=1e-9)

    sig_pow = torch.mean(x ** 2, dim=1)
    noise_pow = sig_pow / 10 ** (d["snr_db"] / 10)
    x = x + noise * torch.sqrt(noise_pow)[:, None]

    bins = 1200 * torch.log2(f0 / PENN_FMIN) / PENN_CENTS_PER_BIN
    bc = arange(0, PENN_PITCH_BINS, torch.float32).to(dtype)
    target = torch.exp(-0.5 * ((bc[None, :] - bins[:, None])
                               * PENN_CENTS_PER_BIN / TARGET_STD_CENTS) ** 2)

    unvoiced = d["unvoiced"] < 0.10
    x = torch.where(unvoiced[:, None], noise, x)
    target = torch.where(unvoiced[:, None], 1.0, target)

    x = x * d["level"]
    target = target / torch.sum(target, dim=1, keepdim=True)
    return x, target


def synth_batch_device(key: torch.Tensor, batch: int, device,
                       dtype=torch.float32):
    """``tools/train_fcnf0.py:synth_batch_device`` on the port: one batch
    from ``key`` on ``device``, computed in ``dtype`` (the JAX trainer
    computes in JAX's default dtype and returns float32; here the caller
    casts)."""
    return synth_from_draws(corpus_draws(key, batch, device, dtype))


# ----------------------------------------------------------------- train
class Adam:
    """Adam as the JAX trainers take it: m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, p -= lr * mhat / (sqrt(vhat) + eps) with
    mhat = m / (1 - b1^t), vhat = v / (1 - b2^t) at update count t
    (``tools/train_fcnf0.py:227-240``; ``optax.adam``'s, its learning rate
    taken at the count before the increment).  ``lr`` is a number or a
    function of that count.  The count lives on the host, so an update
    reads nothing back; it is a few multi-tensor launches."""

    def __init__(self, params: list, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.params = list(params)
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads) -> None:
        lr = float(self.lr(self.count))
        self.count += 1
        b1, b2, t = self.b1, self.b2, self.count
        grads = list(grads)
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1 - b2)
        mhat = torch._foreach_div(self.m, 1 - b1 ** t)
        den = torch._foreach_div(self.v, 1 - b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_addcdiv_(self.params, mhat, den, value=-lr)


def loss_fn(params: dict, x: torch.Tensor, target: torch.Tensor,
            precision: str = "full") -> torch.Tensor:
    """Softmax cross-entropy against the blurred targets (penn's loss)."""
    logits = fcnf0_forward(params, x, precision=precision)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))


class Trainer:
    """FCNF0's parameters as leaves that require gradients, under the
    checkpoint's names, on ``device``, with their Adam state.  They are
    float32, as the JAX trainer's; ``dtype=torch.float64`` serves
    comparisons."""

    def __init__(self, params: dict, device=None, lr: float = 2e-4,
                 precision: str | None = None,
                 dtype=torch.float32) -> None:
        self.device = resolve_device(device)
        self.precision = (PitchExtractionByFCNF0.PRECISION
                          if precision is None else precision)
        self.params = {
            k: torch.tensor(np.asarray(params[k]), dtype=dtype,
                            device=self.device, requires_grad=True)
            for k in fcnf0_shapes()}
        self.adam = Adam(self.params.values(), lr)

    def loss_and_grads(self, x: torch.Tensor, target: torch.Tensor):
        """The loss (a 0-d tensor on the device) and the gradients in the
        parameters' order; forward and backward in the trainer's
        precision."""
        with network_precision(self.precision):
            loss = loss_fn(self.params, x, target, self.precision)
            grads = torch.autograd.grad(loss, list(self.params.values()))
        return loss.detach(), grads

    def step(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss, grads = self.loss_and_grads(x, target)
        self.adam.update(grads)
        return loss

    @torch.no_grad()
    def evaluate(self, x: torch.Tensor):
        """``eval_fn`` (``tools/train_fcnf0.py:269-274``): the argmax bin
        and the periodicity from the entropy of each frame."""
        logits = fcnf0_forward(self.params, x, precision=self.precision)
        probs = torch.softmax(logits, dim=-1)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-20)),
                         dim=-1)
        return (torch.argmax(probs, dim=-1),
                1.0 - ent / math.log(PENN_PITCH_BINS))

    def numpy_params(self) -> dict:
        return {k: p.detach().cpu().numpy() for k, p in self.params.items()}

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **self.numpy_params())


def report(trainer: Trainer, rng: np.random.Generator, frames: int) -> str:
    """RPA50 over the voiced frames of a numpy eval batch and the mean
    periodicity voiced and unvoiced (``tools/train_fcnf0.py:291-306``)."""
    xe, te = synth_batch(rng, frames)
    bins_hat, period = trainer.evaluate(
        torch.as_tensor(xe, device=trainer.device))
    bins_hat, period = bins_hat.cpu().numpy(), period.cpu().numpy()
    voiced = te.max(axis=1) > 2.0 / PENN_PITCH_BINS
    err_cents = np.abs(bins_hat - te.argmax(axis=1))[voiced] \
        * PENN_CENTS_PER_BIN
    rpa50 = float((err_cents <= 50).mean())
    p_u = float(period[~voiced].mean()) if (~voiced).any() else float("nan")
    return (f"RPA50 {rpa50:.3f} P_v {float(period[voiced].mean()):.2f} "
            f"P_u {p_u:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--resume", default=None,
                    help="npz checkpoint to continue from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--log-every", type=int, default=500,
                    help="steps between the loss reads, evals and "
                         "checkpoints")
    ap.add_argument("--eval-frames", type=int, default=256)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.resume:
        params = load_params(args.resume, None, expect=fcnf0_shapes())
    else:
        params = init_fcnf0_params(args.seed)
    trainer = Trainer(params, device, args.lr)

    rng = np.random.default_rng(args.seed + 1)
    on_card = device.type == "cuda"
    key = prng.PRNGKey(args.seed + 99)            # on the host
    t0 = time.time()
    for step in range(1, args.steps + 1):
        if on_card:
            key, sub = prng.split(key)
            x, target = synth_batch_device(sub, args.batch, device)
        else:
            x, target = (torch.as_tensor(a, device=device)
                         for a in synth_batch(rng, args.batch))
        loss = trainer.step(x, target)
        if step % args.log_every == 0 or step == args.steps:
            rate = step * args.batch / (time.time() - t0)
            print(f"step {step:6d} loss {float(loss):.4f} "
                  f"{report(trainer, rng, args.eval_frames)} "
                  f"({rate:.0f} frames/s)", flush=True)
            # periodic checkpoint: long runs must survive interruption
            trainer.save(args.out)
    trainer.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
