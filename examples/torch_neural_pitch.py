"""Neural pitch tracking with the bundled CREPE-tiny checkpoint on the
PyTorch port: the counterpart of examples/neural_pitch.py.

    python examples/torch_neural_pitch.py [--wav in.wav]
        [--algorithm crepe|fcnf0] [--device cpu]

Compares the network's f0 track against YIN on the same audio and
reports voiced-frame agreement in cents.  The weights are the JAX
package's bundled checkpoints (diffsptk_tpu/assets/crepe_tiny_synth.npz,
fcnf0_synth.npz, trained in-repo on synthetic pitched audio), read by the
port's own loader.  Without ``--wav`` it takes synthetic speech made from
``--seed``, whose f0 glide it also reports the tracks against.  It runs
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
from torch_common import parser, speech


def cents(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return 1200 * np.abs(np.log2(a / b))


def main(argv=None) -> float:
    ap = parser(__doc__)
    ap.add_argument("--algorithm", default="crepe", choices=("crepe", "fcnf0"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x, sr = speech(args, device)
    kw = dict(out_format="f0", f_min=60, f_max=400, device=device,
              dtype=torch.float32)
    net_kw = dict(model="tiny") if args.algorithm == "crepe" else {}
    with torch.no_grad():
        net = pt.Pitch(80, sr, algorithm=args.algorithm, **net_kw, **kw)(x)
        yin = pt.Pitch(80, sr, algorithm="yin", **kw)(x)
    net, yin = net.cpu().numpy(), yin.cpu().numpy()
    n = min(len(net), len(yin))
    both = (net[:n] > 0) & (yin[:n] > 0)
    med = float(np.median(cents(net[:n][both], yin[:n][both]))) \
        if both.any() else float("nan")
    print(f"{n} frames; voiced (both trackers): {int(both.sum())}")
    print(f"{args.algorithm}-vs-yin median |error|: {med:.1f} cents")
    if not args.wav:
        rng = np.random.default_rng(args.seed)
        lo, hi = rng.uniform(90, 140), rng.uniform(180, 260)
        glide = lo + (hi - lo) * np.minimum(
            np.arange(n) * 80 / (args.length - 1), 1.0)
        voiced = net[:n] > 0
        print(f"{args.algorithm}-vs-known-f0 median |error|: "
              f"{float(np.median(cents(net[:n][voiced], glide[voiced]))):.1f}"
              " cents")
    print(f"{args.algorithm} f0 (Hz), every 10th frame:")
    print(np.round(net[::10], 1))
    return med


if __name__ == "__main__":
    main()
