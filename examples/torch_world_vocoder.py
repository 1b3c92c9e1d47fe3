"""WORLD analysis-synthesis (BASELINE config #4) on the PyTorch port:
the counterpart of examples/world_vocoder.py.

    python examples/torch_world_vocoder.py [--wav in.wav] [--out out.wav]
        [--device cpu]

Without ``--wav`` it takes synthetic speech made from ``--seed``.  It runs
on the card unless ``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.core import resolve_device
from diffsptk_tpu_torch.models import WorldVocoder
from torch_common import parser, speech


def main(argv=None) -> float:
    ap = parser(__doc__)
    ap.add_argument("--out", default=None, help="write the result here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x, sr = speech(args, device)
    kw = dict(device=device, dtype=torch.float32)
    voc = WorldVocoder(80, sr, 1024, f_min=80, f_max=400, **kw)
    spec = pt.STFT(400, 80, 512, out_format="db", **kw)
    with torch.no_grad():
        y = voc.analysis_synthesis(x)
        Sx, Sy = spec(x).cpu().numpy(), spec(y).cpu().numpy()
    n = min(Sx.shape[0], Sy.shape[0])
    corr = float(np.corrcoef(Sx[:n].ravel(), Sy[:n].ravel())[0, 1])
    print(f"magnitude-spectrogram correlation: {corr:.3f}")
    if args.out:
        pt.write(args.out, y, sr)
    return corr


if __name__ == "__main__":
    main()
