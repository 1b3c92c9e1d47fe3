#!/usr/bin/env python3
"""Time the Newton solve (B1) and the windowed gather (B6) of one checkout
of the port, so that two checkouts can be compared in turns in one run.

    python3 tools/torch_newton_gather_ab.py [TREE [LABEL]]

TREE (default: this checkout) is the root of a checkout of the port: its
``diffsptk_tpu_torch`` is imported and its two kernels are built.  The
inputs are chip_smoke.py's: the Newton solve at n=25, B=7,680 ([K1]), and
the gather at the call sites of one ``WorldVocoder(ap_algorithm="d4c")``
analysis of 32 x 19,200 samples of synthetic speech ([K6]), recorded with
the dither's generator seeded, so that every checkout sees the same
sites.  For each kernel (the gather per site and summed) it prints:
- per call: CUDA-event ms per call over 100 calls back to back; where the
  wrapper's host time exceeds the device's, this is the host's time;
- kernel: the kernel's own device ms (torch.profiler, 20 calls);
- wrapper: the device ms of everything the wrapper enqueues;
and the bound, from the bytes that must move, at 3.35 TB/s.  Every line
ends with the card's name and power limit.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(tree)
    smoke = _smoke()
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import build, gather, newton

    smoke.check(pt.__file__.startswith(tree), f"imported {pt.__file__}")
    build.build(("newton", "gather"))
    card = smoke.smi()
    dev = torch.device("cuda")

    n, B = 25, 7680
    rng = np.random.default_rng(7)
    rt = rng.standard_normal((2 * n - 1, B)).astype(np.float32) * 0.1
    rt[0] += 4.0 + n * 0.2
    b = rng.standard_normal((n, B)).astype(np.float32)
    rt_t, b_t = (torch.as_tensor(a, device=dev) for a in (rt, b))

    def solve():
        return newton.newton_solve_lane_major(rt_t, b_t)

    call = smoke.cuda_ms(torch, solve, 100)
    own, wrap = smoke.kernel_device_ms(torch, solve, "newton_kernel")
    bound = smoke.bound_ms((2 * n - 1 + 2 * n) * B * 4.0, 0.0)[0]
    print(f"[ab] {label} B1 n={n} B={B}: per call {call:.4f} ms, kernel "
          f"{own:.4f} ms, wrapper {wrap:.4f} ms, bound {bound:.5f} ms "
          f"| {card}", flush=True)

    xs = torch.as_tensor(smoke.synth_speech(32, 19200), device=dev)
    voc = pt.WorldVocoder(ap_algorithm="d4c", device=dev,
                          dtype=torch.float32)
    sites = []
    undo = smoke.record_calls(gather, "gather_windows_cuda", sites)
    torch.manual_seed(0)
    with torch.no_grad():
        voc.analyze(xs)
    torch.cuda.synchronize()
    undo()
    total = [0.0] * 4
    for (x, starts, length), _ in sites:
        def fn():
            return gather.gather_windows_cuda(x, starts, length)

        call = smoke.cuda_ms(torch, fn, 100)
        own, wrap = smoke.kernel_device_ms(torch, fn, "gather_kernel")
        nbytes = (smoke.covered_samples(torch, x.shape[-1], starts, length)
                  + starts.numel() + starts.numel() * length) * 4.0
        bound = smoke.bound_ms(nbytes, 0.0)[0]
        for i, v in enumerate((call, own, wrap, bound)):
            total[i] += v
        print(f"[ab] {label} B6 site {tuple(x.shape)} N={starts.shape[1]} "
              f"L={length}: per call {call:.4f} ms, kernel {own:.4f} ms "
              f"({nbytes / own / 1e9:.3f} TB/s), wrapper {wrap:.4f} ms, "
              f"bound {bound:.5f} ms | {card}", flush=True)
    print(f"[ab] {label} B6 {len(sites)} sites: per call {total[0]:.4f} ms, "
          f"kernel {total[1]:.4f} ms ({100 * total[3] / total[1]:.1f} % of "
          f"the bound), wrapper {total[2]:.4f} ms, bound {total[3]:.5f} ms "
          f"| {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
