"""Entry points of the port (counterpart of the JAX repository's
``__graft_entry__.py``).

    python -m diffsptk_tpu_torch.entry [N] [--device cpu]

entry()             -> (fn, example_args): the flagship forward step on one
                       card (STFT -> mcep Newton -> MLSA analysis-synthesis).
dryrun_multichip(n) -> one training step (``parallel/train.py``) over an
                       n-rank (dp, tp) mesh, one NCCL rank a card; rank 0
                       prints the JAX package's line.  ``device="cpu"``
                       runs gloo ranks on the CPU instead.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .core import resolve_device

PATHS = ("ShardedSTFT, ShardedMelCepstralVocoder, "
         "ShardedMelCepstralVocoder(halo=bulk), ShardedWorldVocoder, "
         "ShardedAllPoleDigitalFilter, ShardedMDCT/IMDCT, ShardedPQMF/IPQMF")


def entry(device=None):
    """The flagship pipeline's forward step and an example input (8 x 1,600
    samples) on ``device`` (the card unless ``device="cpu"``)."""
    from .models import MelCepstralVocoder

    voc = MelCepstralVocoder(frame_length=400, frame_period=80,
                             fft_length=512, cep_order=24, alpha=0.42,
                             n_iter=10, device=device)
    x = torch.zeros((8, 1600), device=resolve_device(device)) + 1e-3
    return voc.analysis_synthesis, (x,)


def _step(rank: int, world: int, device: str, dp: int, tp: int) -> float:
    """One rank of the dryrun (``parallel.ranks.spawn_ranks``' worker): its
    blocks of the float32 inputs through one ``DryrunStep.train_step``;
    rank 0 prints the line.  Returns the loss."""
    from .parallel import make_mesh
    from .parallel.train import DryrunStep, dryrun_inputs, dryrun_shape

    mesh = make_mesh((dp, tp), device_type=device)
    step = DryrunStep(mesh, device=device, dtype=torch.float32)
    _, _, B, T = dryrun_shape(world)
    inputs = dryrun_inputs(B, T, np.float32)
    p = step.params_from_jax({"window": {"window": step.window_init()},
                              "mc": inputs["mc"], "lpc": inputs["lpc"]})
    loss, _ = step.train_step(p, *step.blocks(inputs))
    value = float(loss)
    if rank == 0:
        print(f"dryrun_multichip: mesh=({dp}x{tp}) flagship 400/80/512 "
              f"cep24 loss={value:.6f} paths=[{PATHS}] OK", flush=True)
    return value


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Run one training step over an n-device mesh and return its loss.

    The mesh takes the JAX package's rule, (dp, tp) = (max(1, n // 2),
    n // dp), and the inputs its shapes: B = max(2, dp) rows of T = 2,400
    tp samples, float32, drawn as the JAX dryrun draws them.  Each of the
    dp * tp ranks is a process of its own (``parallel.ranks.spawn_ranks``):
    on ``device=None`` one NCCL rank a card, with ``device="cpu"`` gloo
    ranks.  There is no fallback: without a card, or
    with fewer cards (or CPU cores) than n, it raises before it starts a
    rank."""
    from .parallel.ranks import spawn_ranks
    from .parallel.train import dryrun_shape

    device_type = resolve_device(device).type
    have = (torch.cuda.device_count() if device_type == "cuda"
            else os.cpu_count() or 1)
    if not 1 <= n_devices <= have:
        kind = "cards" if device_type == "cuda" else "CPU cores"
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} {kind} (one "
            f"rank each), have {have}")
    dp, tp, _, _ = dryrun_shape(n_devices)
    return spawn_ranks(_step, dp * tp, device_type, dp, tp)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="One training step through every sharded path over "
                    "an N-rank (dp, tp) mesh.")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks: cards, or CPU processes with --device cpu")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks (default: one card a rank)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
