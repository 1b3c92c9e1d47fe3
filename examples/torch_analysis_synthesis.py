"""Mel-cepstral analysis-synthesis (BASELINE config #3) on the PyTorch
port: the counterpart of examples/analysis_synthesis.py.

    python examples/torch_analysis_synthesis.py [--wav in.wav]
        [--out out.wav] [--cascade fused|folded|stages]
        [--precision HIGHEST|HIGH|DEFAULT] [--device cpu]

Without ``--wav`` it takes synthetic speech made from ``--seed``.  It runs
on the card unless ``--device cpu`` is given; there ``--cascade fused``
(the default) runs the synthesis' Taylor cascades through the cascade
kernels, at ``--precision``: the fp32 kernel by default, the tensor-core
kernels at "HIGH" (bf16x3) or "DEFAULT" (one bf16 pass, which the
inverse-then-forward round trip does not survive).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.core import resolve_device
from diffsptk_tpu_torch.models import MelCepstralVocoder
from torch_common import parser, speech


def main(argv=None) -> float:
    ap = parser(__doc__)
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--cascade", default="fused",
                    choices=("fused", "folded", "stages"))
    ap.add_argument("--precision", default=None,
                    choices=("HIGHEST", "HIGH", "DEFAULT"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    x, sr = speech(args, device)
    voc = MelCepstralVocoder(frame_length=400, frame_period=80,
                             fft_length=512, cep_order=24,
                             alpha=pt.get_alpha(sr), n_iter=10,
                             cascade=args.cascade,
                             cascade_precision=args.precision,
                             device=device, dtype=torch.float32)
    T = x.shape[-1] - x.shape[-1] % 80
    x = x[:T]
    with torch.no_grad():
        y = voc.analysis_synthesis(x)
    x64, y64 = x.double(), y.double()
    snr = float(10 * torch.log10((x64 ** 2).sum() / ((y64 - x64) ** 2).sum()))
    print(f"round-trip SNR: {snr:.1f} dB ({T} samples on {device}, cascade "
          f"{args.cascade}, precision {args.precision or 'HIGHEST'})")
    if args.out:
        pt.write(args.out, y, sr)
    return snr


if __name__ == "__main__":
    main()
