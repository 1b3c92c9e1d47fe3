#!/usr/bin/env python3
"""Where a stage of the port's cascade kernel spends its time.

    python3 tools/torch_cascade_ablation.py

Builds ``diffsptk_tpu_torch/csrc/mlsa_cascade.cu`` as it is and with
``MLSA_ABLATE_TAPS`` (no tap loop: each stage only copies its tile into
shared memory, blends zeros and stores; wrong values, only the rest is
timed), both at once.  Each runs ``kernels.mlsa.cascade_chunked_cuda``
(20 stages, one launch each) at the flagship geometry (B=32, N=240, P=80,
M=199) and at the 48 kHz one (P=240) in turns, forward then backward
through the list, and the script prints CUDA-event ms per call with the
card's name and power limit.

Then, at the flagship geometry, the host's time to enqueue one 20-stage
cascade through each layer of the wrapper, in turns: ``taylor_cascade``
(which skips the autograd Function when no input needs a gradient),
``TaylorCascade.apply`` (the Function), ``cascade_chunked_cuda`` (the
entry alone), and the one ``torch.stack`` of the weights and Taylor
coefficients that the entry needed before it took them as two pointers.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = {
    "full": (),
    "without the tap loop": ("MLSA_ABLATE_TAPS",),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from diffsptk_tpu_torch.kernels import build, mlsa

    build.build([("mlsa_cascade", d) for d in VARIANTS.values()])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    B, N, M, S = 32, 240, 199, 20
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    weights = torch.as_tensor(np.insert(1.0 / np.arange(1, S + 1), 0, 1.0),
                              dtype=torch.float32, device=dev)
    a = torch.ones(S + 1, dtype=torch.float32, device=dev)
    for P in (80, 240):
        x = torch.as_tensor(rng.standard_normal((B, N, P)),
                            dtype=torch.float32, device=dev)
        c = torch.as_tensor(rng.standard_normal((B, N, M + 1)) * 0.01,
                            dtype=torch.float32, device=dev)
        times = {name: [] for name in VARIANTS}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            def call():
                mlsa.cascade_chunked_cuda(x, c, weights, a, P, 0, 3 * P,
                                          _defines=VARIANTS[name])
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            stop.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(stop) / 20)
        for name, ts in times.items():
            print(f"[ablation] P={P} M={M} {name}: "
                  + ", ".join(f"{t:.4f}" for t in ts)
                  + f" ms per {S}-stage call | {card}")
    host_times(torch, mlsa, weights, a, card, B, N, M, S, rng)
    return 0


def host_times(torch, mlsa, weights, a, card, B, N, M, S, rng,
               rounds: int = 15, calls: int = 10) -> None:
    """Print the median host time per call of each wrapper layer at P=80:
    each round takes every layer in turn (forward, then backward through
    the list), ``calls`` calls between synchronizations (at most 200
    launches, which the queue holds)."""
    from diffsptk_tpu_torch.kernels.mlsa_cascade import lane_aligned_nfft

    P = 80
    dev = weights.device
    x = torch.as_tensor(rng.standard_normal((B, N * P)),
                        dtype=torch.float32, device=dev)
    c = torch.as_tensor(rng.standard_normal((B, N, M + 1)) * 0.01,
                        dtype=torch.float32, device=dev)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    xq = x.reshape(B, N, P)
    layers = {
        "taylor_cascade": lambda: mlsa.taylor_cascade(
            x, c, weights, a, P, 0, nfft),
        "TaylorCascade.apply": lambda: mlsa.TaylorCascade.apply(
            x, c, weights, a, P, 0, nfft),
        "cascade_chunked_cuda": lambda: mlsa.cascade_chunked_cuda(
            xq, c, weights, a, P, 0, 3 * P),
        "torch.stack of weights and a": lambda: torch.stack(
            [weights, a]).to(device=dev, dtype=torch.float32).contiguous(),
    }
    times = {name: [] for name in layers}
    for fn in layers.values():
        fn()
    for r in range(rounds):
        order = list(layers) if r % 2 == 0 else list(layers)[::-1]
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                layers[name]()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    for name, ts in times.items():
        print(f"[host] P={P} M={M} B={B} {name}: median "
              f"{float(np.median(ts)):.2f} us per call (min "
              f"{min(ts):.2f}, max {max(ts):.2f}, {rounds} rounds of "
              f"{calls} calls) | {card}")


if __name__ == "__main__":
    sys.exit(main())
