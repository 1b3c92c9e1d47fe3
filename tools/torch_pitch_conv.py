#!/usr/bin/env python3
"""Time the neural pitch trackers' conv stacks on the card, layer by layer,
under each setting of cuDNN that the port could take.

    python3 tools/torch_pitch_conv.py

The shapes are chip_smoke.py's [pitch-fcnf0] and [pitch-crepe] calls: 32 x
19,200 samples at 16 kHz, 7,712 frames of 1,024 samples, run 2,048 frames
at a time (``pitch_nn.FRAMES_PER_CHUNK``); CREPE is "tiny".  Each
layer is one ``F.conv1d`` on random inputs of its shape (its time does not
depend on the values).  For every setting -- TF32 or full fp32, cuDNN's
heuristic choice or its benchmarked choice (``cudnn.benchmark``), the
activations in NCL or as channels-last 2-D (N, C, 1, L) -- it prints each
layer's CUDA-event ms per call (20 calls after warm-up), its TFLOP/s, and
the stack's total for the call's 7,712 frames, with the card's name and
power limit; then the same for the port's own layer call
(``pitch_nn.conv``) at each ``nn_precision``.  Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layers(algo: str):
    """(name, in_channels, out_channels, kernel, stride, padding, input
    length) of each conv of a network, from its layer plan."""
    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    out = []
    if algo == "fcnf0":
        L, k = 993, nn_._FCNF0_KERNEL
        for i, (ci, co, _ln, pool) in enumerate(nn_._FCNF0_BLOCKS):
            out.append((f"block{i}", ci, co, k, 1, 0, L))
            L = L - k + 1
            L = L // pool[1] if pool else L
        out.append(("head", 512, nn_.PENN_PITCH_BINS, 4, 1, 0, L))
    else:
        cap = nn_._CREPE_CAPACITY["tiny"]
        L = nn_.CREPE_WINDOW_SIZE
        for i, (ci, co, k, st, pad) in enumerate(zip(
                cap["in_channels"], cap["out_channels"], nn_._CREPE_KERNELS,
                nn_._CREPE_STRIDES, nn_._CREPE_PADS), start=1):
            out.append((f"conv{i}", ci, co, k, st, sum(pad), L))
            L = ((L + sum(pad) - k) // st + 1) // 2
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    if not torch.cuda.is_available():
        print("torch_pitch_conv: no CUDA device", file=sys.stderr)
        return 1
    sm = _smoke()
    card = sm.smi()
    dev = torch.device("cuda")
    frames, chunk = 7712, 2048
    n_chunks = frames / chunk
    torch.manual_seed(0)
    for algo in ("fcnf0", "crepe"):
        plan = layers(algo)
        inputs = [(torch.randn(chunk, ci, Lin + pad, device=dev),
                   torch.randn(co, ci, k, device=dev) * (ci * k) ** -0.5,
                   st, 2.0 * co * ci * k * ((Lin + pad - k) // st + 1))
                  for _name, ci, co, k, st, pad, Lin in plan]
        for tf32 in (True, False):
            for bench in (False, True):
                for layout in ("ncl", "nhwc"):
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.backends.cudnn.benchmark = bench
                    parts, total = [], 0.0
                    for (name, *_), (x, w, st, flop) in zip(plan, inputs):
                        if layout == "nhwc":
                            x4 = x[:, :, None, :].contiguous(
                                memory_format=torch.channels_last)
                            w4 = w[:, :, None, :].contiguous(
                                memory_format=torch.channels_last)

                            def fn(x4=x4, w4=w4, st=st):
                                return F.conv2d(x4, w4, stride=(1, st))
                        else:
                            def fn(x=x, w=w, st=st):
                                return F.conv1d(x, w, stride=st)
                        ms = sm.cuda_ms(torch, fn, 20, warm=3)
                        total += ms * n_chunks
                        parts.append(f"{name} {ms * n_chunks:.3f} ms "
                                     f"({flop * chunk / ms / 1e9:.1f} "
                                     f"TFLOP/s)")
                    print(f"[conv] {algo} {'tf32' if tf32 else 'fp32'} "
                          f"{'benchmark' if bench else 'heuristic'} "
                          f"{layout}: stack {total:.3f} ms per 7,712 "
                          f"frames; " + "; ".join(parts) + f" | {card}",
                          flush=True)
        torch.backends.cudnn.benchmark = False
        for prec in ("tf32", "full"):
            parts, total = [], 0.0
            for (name, *_), (x, w, st, flop) in zip(plan, inputs):
                ms = sm.cuda_ms(torch, lambda x=x, w=w, st=st: nn_.conv(
                    x, w, stride=st, precision=prec), 20, warm=3)
                total += ms * n_chunks
                parts.append(f"{name} {ms * n_chunks:.3f} ms "
                             f"({flop * chunk / ms / 1e9:.1f} TFLOP/s)")
            print(f"[conv] {algo} the port's pitch_nn.conv, precision "
                  f"{prec} (its layout copies included): stack {total:.3f} "
                  f"ms per 7,712 frames; " + "; ".join(parts) + f" | {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
