#!/usr/bin/env python3
"""Time the overlap-add (B7) and the WORLD chain around it in one checkout
of the port, so that two checkouts can be compared in turns in one run.

    python3 tools/torch_ola_ab.py [TREE [LABEL]]

TREE (default: this checkout) is the root of a checkout of the port: its
``diffsptk_tpu_torch`` is imported and its kernels are built.  The input is
chip_smoke.py's [world] call: ``WorldVocoder(ap_algorithm="d4c")`` on 32 x
19,200 samples of synthetic speech, whose synthesis's overlap-add call is
recorded once and replayed.  It prints, each line ending with the card's
name and power limit:
- B7: CUDA-event ms per call over 100 calls back to back, the kernel's own
  device ms (torch.profiler, 20 calls, every device function whose name
  holds ``ola_``), the device ms of everything the wrapper enqueues, and
  the bound from the bytes that must move at 3.35 TB/s; for the two-pass
  kernel, its device ms at 32, 64, 128 and 256 slots a group;
- the synthesis alone (``voc.synthesize`` on the recorded analysis) and the
  whole ``analysis_synthesis``: the median CUDA-event ms of 20 calls and
  the profiler's device-busy ms and share of one call.
Needs a CUDA card and nvcc.
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
    from diffsptk_tpu_torch.kernels import build, ola

    smoke.check(pt.__file__.startswith(tree), f"imported {pt.__file__}")
    build.build()
    card = smoke.smi()
    torch.backends.cuda.matmul.allow_tf32 = False

    xs = torch.as_tensor(smoke.synth_speech(32, 19200), device="cuda")
    voc = pt.WorldVocoder(ap_algorithm="d4c", device="cuda",
                          dtype=torch.float32)
    sites = []
    with torch.no_grad():
        f0, ap, sp = voc.analyze(xs)
        undo = smoke.record_calls(ola, "overlap_add_cuda", sites)
        voc.synthesize(f0, ap, sp, out_length=xs.shape[-1])
        torch.cuda.synchronize()
        undo()
        (tidx, resp, out_len), _ = sites[0]
        B, P, L = resp.shape

        def kernel():
            return ola.overlap_add_cuda(tidx, resp, out_len)

        call = smoke.cuda_ms(torch, kernel, 100)
        own, wrap = smoke.kernel_device_ms(torch, kernel, "ola_")
        nbytes = (resp.numel() + B * out_len) * 4.0 + tidx.numel() * 8.0
        bound = smoke.bound_ms(nbytes, 0.0)[0]
        print(f"[ab] {label} B7 B={B} slots={P} L={L} out={out_len}: per "
              f"call {call:.4f} ms, kernel {own:.4f} ms ("
              f"{100 * bound / own:.1f} % of the bound), wrapper "
              f"{wrap:.4f} ms, bound {bound:.5f} ms | {card}", flush=True)
        if hasattr(ola, "GROUP"):       # the two-pass kernel's group size
            shipped, sweep = ola.GROUP, []
            for group in (32, 64, 128, 256):
                ola.GROUP = group
                ms = smoke.kernel_device_ms(torch, kernel, "ola_")[0]
                sweep.append(f"{group}: {ms:.4f}")
            ola.GROUP = shipped
            print(f"[ab] {label} B7 kernel ms by slots a group: "
                  + ", ".join(sweep) + f" | {card}", flush=True)

        for name, fn in (
                ("synthesis", lambda: voc.synthesize(
                    f0, ap, sp, out_length=xs.shape[-1])),
                ("world", lambda: voc.analysis_synthesis(xs))):
            med = float(np.median(smoke.cuda_call_ms(torch, fn, 20)))
            prof = smoke.profile_chain(torch, fn)
            print(f"[ab] {label} {name}: median {med:.3f} ms per call, "
                  f"{smoke.busy_share(prof[0], prof[4])} | {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
