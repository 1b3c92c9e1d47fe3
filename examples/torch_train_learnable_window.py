"""Train a learnable STFT window to recover the Hanning window from
spectrogram supervision, on the PyTorch port: the counterpart of
examples/train_learnable_window.py, the minimal ``learnable`` example.

    python examples/torch_train_learnable_window.py [--wav PATH]
        [--steps N] [--device cpu]

Without ``--wav`` it takes synthetic speech made from ``--seed``: a pulse
train with a gliding f0 through three formant resonators, plus a little
noise.  It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.core import resolve_device
from torch_common import synthetic_speech


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wav", default=None, help="a wav file to fit on")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--length", type=int, default=19200,
                    help="samples of synthetic speech without --wav")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.wav:
        x, _ = pt.read(args.wav, dtype=torch.float32, device=device)
    else:
        x = synthetic_speech(args.length, seed=args.seed).to(
            device=device, dtype=torch.float32)
    kw = dict(norm="none", out_format="power", device=device,
              dtype=torch.float32)
    target_op = pt.STFT(400, 80, 512, window="hanning", **kw)
    stft = pt.STFT(400, 80, 512, window="rectangular", learnable=["window"],
                   eps=1e-8, **kw)
    with torch.no_grad():
        target = torch.log(target_op(x) + 1e-8)

    opt = torch.optim.Adam(stft.parameters(), lr=3e-2)
    losses = []
    for i in range(args.steps):
        opt.zero_grad()
        loss = torch.mean((torch.log(stft(x) + 1e-8) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i % 75 == 0:
            print(f"step {i}: loss {float(losses[-1]):.4f}")
    learned = np.abs(next(stft.parameters()).detach().cpu().numpy())
    hann = np.hanning(402)[1:-1]
    corr = np.corrcoef(learned[:400], hann)[0, 1]
    print(f"correlation of |learned window| with hanning: {corr:.3f}")
    return [float(v) for v in losses]


if __name__ == "__main__":
    main()
