#!/usr/bin/env python3
"""Where a stage of the port's cascade kernel spends its time.

    python3 tools/torch_cascade_ablation.py

Builds ``diffsptk_tpu_torch/csrc/mlsa_cascade.cu`` as it is and with the
macros ``MLSA_ABLATE_FORWARD`` (no forward-plan product),
``MLSA_ABLATE_INVERSE`` (no inverse-plan product) and both, all at once.
The variants compute wrong values; they only time the rest.  Each runs
``kernels.mlsa.cascade_chunked_cuda`` (20 stages) at the flagship
geometry (B=32, N=240, P=80, M=199) in turns, forward then backward
through the list, and the script prints CUDA-event ms per call with the
card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = {
    "full": (),
    "without forward plans": ("MLSA_ABLATE_FORWARD",),
    "without inverse plans": ("MLSA_ABLATE_INVERSE",),
    "without both": ("MLSA_ABLATE_FORWARD", "MLSA_ABLATE_INVERSE"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from diffsptk_tpu_torch.kernels import build, mlsa

    build.build([("mlsa_cascade", d) for d in VARIANTS.values()])

    B, N, P, M, S = 32, 240, 80, 199, 20
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    x = torch.as_tensor(rng.standard_normal((B, N, P)), dtype=torch.float32,
                        device=dev)
    c = torch.as_tensor(rng.standard_normal((B, N, M + 1)) * 0.01,
                        dtype=torch.float32, device=dev)
    weights = torch.as_tensor(np.insert(1.0 / np.arange(1, S + 1), 0, 1.0),
                              dtype=torch.float32, device=dev)
    a = torch.ones(S + 1, dtype=torch.float32, device=dev)

    times = {name: [] for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        def call():
            mlsa.cascade_chunked_cuda(x, c, weights, a, P, 0, 254,
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for name, ts in times.items():
        print(f"[ablation] {name}: " + ", ".join(f"{t:.4f}" for t in ts)
              + f" ms per 20-stage call | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
