#!/usr/bin/env python3
"""The FCNF0 trainer's gradient precision and step cost on the card.

    python3 tools/torch_train_precision.py [--batch 64]

One training step's gradients (``tools/torch_train_fcnf0.py``'s
``Trainer.loss_and_grads``) at ``init_fcnf0_params(0)`` on one device
batch (``PRNGKey(8)``, as chip_smoke.py's [train-pitch]), each as its
largest distance from the CPU twin's float64 gradients over max|g|, with
the three parameters that lie farthest: the CPU's float32, the card's
float64, and the card's full fp32 and TF32 under cuDNN's heuristic,
deterministic and benchmarked choices and with cuDNN off (then also
against the CPU's float32).  For each card setting: the CUDA-event ms of
the forward and backward (10 calls after warm-up) and its costliest
device functions.  Prints the card's name and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffsptk_tpu_torch.ops.pitch_nn import init_fcnf0_params
    from diffsptk_tpu_torch.utils import prng

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_precision: no CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    TF = cs.train_tool("torch_train_fcnf0")
    card = cs.smi()
    print(f"{card} | torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    init = init_fcnf0_params(0)
    names = list(TF.fcnf0_shapes())
    x, t = TF.synth_batch_device(prng.PRNGKey(8), args.batch, dev)

    def grads(device, dtype=torch.float32, precision=None):
        trainer = TF.Trainer(init, device, precision=precision, dtype=dtype)
        return trainer, trainer.loss_and_grads(
            x.to(device=device, dtype=dtype), t.to(device=device,
                                                   dtype=dtype))[1]

    g64 = grads("cpu", torch.float64)[1]
    g32 = [g.double() for g in grads("cpu")[1]]
    scale = max(float(g.abs().max()) for g in g64)

    def dist(got, ref=g64) -> str:
        e = {n: float((a.cpu().double() - b).abs().max()) / scale
             for n, a, b in zip(names, got, ref)}
        top = sorted(e.items(), key=lambda kv: -kv[1])[:3]
        return (f"{max(e.values()):.3e} ("
                + ", ".join(f"{n} {v:.2e}" for n, v in top) + ")")

    print(f"B={args.batch}, max|g| {scale:.4e}; from the CPU's float64: "
          f"CPU float32 {dist(g32)}; card float64 "
          f"{dist(grads(dev, torch.float64)[1])}", flush=True)
    settings = (("cuDNN heuristic", {}),
                ("cuDNN deterministic", {"deterministic": True}),
                ("cuDNN benchmark", {"benchmark": True}),
                ("cuDNN off", {"enabled": False}))
    for label, setup in settings:
        old = {k: getattr(torch.backends.cudnn, k) for k in setup}
        for k, v in setup.items():
            setattr(torch.backends.cudnn, k, v)
        try:
            for precision in ("full", "tf32"):
                trainer, g = grads(dev, precision=precision)
                ms = cs.cuda_ms(torch, lambda: trainer.loss_and_grads(x, t),
                                10)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    trainer.loss_and_grads(x, t)
                    torch.cuda.synchronize()
                per = {}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        per[e.name] = per.get(e.name, 0.0) \
                            + e.device_time / 1e3
                top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
                print(f"{label}, {precision}: from the CPU's float64 "
                      f"{dist(g)}, from its float32 {dist(g, g32)}; forward "
                      f"and backward {ms:.3f} ms; top device time: "
                      + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top)
                      + f" | {card}", flush=True)
        finally:
            for k, v in old.items():
                setattr(torch.backends.cudnn, k, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
