"""The input, the common options and the ranks of the PyTorch port's
examples.

Each example reads ``--wav``, or, since the repo ships no speech file,
takes synthetic speech made from ``--seed``: a pulse train whose f0
glides, through three formant resonators, plus a little noise.  Each runs
on the card unless ``--device cpu`` is given.  The sharded examples run
one process a rank (``diffsptk_tpu_torch.parallel.ranks.spawn_ranks``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.core import resolve_device
from diffsptk_tpu_torch.kernels import lfilter


def synthetic_speech(length: int, sample_rate: int = 16000,
                     seed: int = 0) -> torch.Tensor:
    """A pulse train whose f0 glides from 90-140 Hz to 180-260 Hz through
    formants at 700, 1220 and 2600 Hz, plus 1e-3 white noise (float64)."""
    rng = np.random.default_rng(seed)
    a = np.array([1.0])
    for f, bw in ((700.0, 130.0), (1220.0, 70.0), (2600.0, 160.0)):
        r = np.exp(-np.pi * bw / sample_rate)
        a = np.convolve(a, [1.0, -2 * r * np.cos(2 * np.pi * f / sample_rate),
                            r * r])
    f0 = np.linspace(rng.uniform(90, 140), rng.uniform(180, 260), length)
    pulses = np.diff(np.floor(np.cumsum(f0 / sample_rate)), prepend=0.0)
    x = lfilter([1.0], a, torch.as_tensor(pulses)).numpy()
    x = 0.5 * x / np.abs(x).max() + 1e-3 * rng.standard_normal(length)
    return torch.as_tensor(x)


def parser(doc: str, length: int = 19200) -> argparse.ArgumentParser:
    """An argument parser with the examples' common options: --wav,
    --seed, --length, --device."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--wav", default=None,
                    help="a 16 kHz wav file (default: synthetic speech)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic speech")
    ap.add_argument("--length", type=int, default=length,
                    help="samples of synthetic speech without --wav")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def speech(args, device, rows: int = 1) -> tuple[torch.Tensor, int]:
    """(x, sample rate): ``--wav``'s first channel, or ``rows`` rows of
    synthetic speech (seeds --seed, --seed + 1, ...), float32 on
    ``device``; (T,) for one row, else (rows, T)."""
    if args.wav:
        x, sr = pt.read(args.wav, dtype=torch.float32, device=device)
        x = x.reshape(-1, x.shape[-1])[0]
        x = x if rows == 1 else x.expand(rows, -1).contiguous()
        return x, sr
    x = torch.stack([synthetic_speech(args.length, seed=args.seed + r)
                     for r in range(rows)])
    x = x.to(device=device, dtype=torch.float32)
    return (x[0] if rows == 1 else x), 16000


def rank_count(args) -> tuple[int, str]:
    """(ranks, device type) of a sharded example: one rank a card on the
    card, ``--ranks`` gloo ranks with ``--device cpu``."""
    device = resolve_device(args.device).type
    if device == "cuda":
        return args.ranks or torch.cuda.device_count(), device
    return args.ranks or 2, device
