#!/usr/bin/env python3
"""Time the tensor-core cascade's two entries (the B2 and B3 rows at
cascade_precision "HIGH" and "DEFAULT") and the vocoders around them in
one checkout of the port, so that two checkouts can be compared in turns
in one run.

    python3 tools/torch_tc_cascade_ab.py [TREE [LABEL]]

TREE (default: this checkout) is the root of a checkout of the port: its
``diffsptk_tpu_torch`` is imported and its kernels are built.  The inputs
are chip_smoke.py's [precision] cases, from its seed: the chunked entry at
the flagship's (B, N, P, M, S) = (32, 240, 80, 199, 20) and the unchunked
entry at [chain48]'s (32, 240, 240, 199, 20).  It prints, each line ending
with the card's name and power limit, for each entry and arm:
- the entry: CUDA-event ms per call (10 calls back to back, per 20
  stages), its device ms (torch.profiler, 20 calls: the union of the
  intervals of the entry's device functions, those whose names hold
  ``tc_``), each function's own device ms, the distance from its twin in
  max|y| and the bound (operations at the bf16 tensor-core peak);
- the library call: the same plan products as cuBLAS bf16 GEMMs with
  fp32 results (chip_smoke.tc_library_ms), timed in the same run;
- where the checkout's entry takes build variants (``_defines``), each
  kernel's device ms launched without programmatic dependence, and so
  without its epilogues, without its products and without both (what
  holds the entry back), and with programmatic dependence but without
  the chunked inverse's L2 prefetch of the next stage's spectra
  (``MLSA_TC_NO_PREFETCH``), each variant's CUDA-event ms per call;
- the flagship vocoder (frame period 80, Taylor order 20) at HIGH:
  ``analysis_synthesis`` (40 launches of the chunked HIGH entry's stages)
  and ``synthesize`` at DEFAULT (20): the median and the least CUDA-event
  ms of 50 calls (the host's enqueue time varies from run to run), and
  the device's busy ms a call (the union of every device function's
  intervals, torch.profiler over 5 calls); the 48 kHz vocoder (frame
  period 240, Taylor order 25) the median over 10 calls (50 and 25 of the
  unchunked entry's).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = (("MLSA_TC_NO_PDL",),
            ("MLSA_TC_NO_PDL", "MLSA_TC_ABLATE_EPILOGUE"),
            ("MLSA_TC_NO_PDL", "MLSA_TC_ABLATE_MMA"),
            ("MLSA_TC_NO_PDL", "MLSA_TC_ABLATE_EPILOGUE",
             "MLSA_TC_ABLATE_MMA"),
            ("MLSA_TC_NO_PREFETCH",))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _functions(smoke, torch, fn):
    """The union device ms of ``fn``'s ``tc_`` functions and each one's
    own (by the part of its name before the template arguments)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "tc_" in e.name]
    each = {}
    for e in events:
        name = e.name.split("<")[0].split("::")[-1]
        each[name] = each.get(name, 0.0) + e.device_time / 1e3 / 20
    return smoke.union_us(events) / 1e3 / 20, each


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
    from diffsptk_tpu_torch.kernels import build, mlsa
    from diffsptk_tpu_torch.kernels.mlsa_cascade import (
        cascade_plan,
        chunked_geometry,
        lane_aligned_nfft,
        taylor_cascade_folded,
    )

    smoke.check(pt.__file__.startswith(tree), f"imported {pt.__file__}")
    entries = {"chunked": mlsa.cascade_chunked_tc_cuda,
               "unchunked": mlsa.cascade_unchunked_tc_cuda}
    variants = {k: ("_defines" in inspect.signature(e).parameters)
                for k, e in entries.items()}
    build.build(tuple(build.SOURCES) + tuple(
        ("mlsa_cascade_tc", v) for v in (VARIANTS if any(variants.values())
                                         else ())))
    card = smoke.smi()
    torch.backends.cuda.matmul.allow_tf32 = False

    with torch.no_grad():
        for name, P in (("chunked", 80), ("unchunked", 240)):
            B, N, M, S = 32, 240, 199, 20
            nfft = lane_aligned_nfft(2 * P + M + 1)
            chunked = chunked_geometry(M, P, nfft)
            smoke.check((chunked is not None) == (name == "chunked"),
                        f"P={P}, M={M} is not the {name} geometry")
            nf, Q = ((chunked[1], chunked[0]) if chunked else (nfft, 1))
            x, c, weights, a = smoke.cascade_case(torch, "cuda", B, N, P, M,
                                                  S, seed=21)
            xq = x.reshape(B, N, P)
            K = nf // 2 + 1
            n_blk = cascade_plan(nf, P - 1 if chunked else M, P, 0)[4]
            entry = entries[name]
            for precision in ("HIGH", "DEFAULT"):
                passes = 3 if precision == "HIGH" else 1

                def kernel(defines=()):
                    kw = {"_defines": defines} if defines else {}
                    return entry(xq, c, weights, a, P, 0, nf, precision,
                                 **kw)

                want = taylor_cascade_folded(x, c, weights, a, P, 0, nfft,
                                             precision)
                got = kernel().reshape(B, N * P)
                torch.cuda.synchronize()
                err = float((got - want).abs().max() / want.abs().max())
                ms = smoke.cuda_ms(torch, kernel, 10)
                dev, each = _functions(smoke, torch, kernel)
                bound = smoke.tc_bound(B, N, P, Q, n_blk, K, S, passes, 0)[0]
                lib, kind = smoke.tc_library_ms(torch, "cuda", B * N, n_blk,
                                                P, K, S, passes)
                print(f"[ab] {label} {name} {precision} (B, N, P, M, S) = "
                      f"{(B, N, P, M, S)}: {ms:.4f} ms per call, device "
                      f"{dev:.4f} ms ("
                      + ", ".join(f"{k} {v:.4f}" for k, v in each.items())
                      + f"), |kernel-twin| {err:.3e} of max|y|, bound "
                      f"{bound:.4f} ms ({ms / bound:.1f}x); library ({kind}) "
                      f"{lib:.4f} ms | {card}", flush=True)
                if not variants[name]:
                    continue
                for defines in VARIANTS:
                    dev_v, each = _functions(smoke, torch,
                                             lambda: kernel(defines))
                    ms_v = smoke.cuda_ms(torch, lambda: kernel(defines), 10)
                    print(f"[ab] {label} {name} {precision} "
                          f"{'+'.join(defines)}: {ms_v:.4f} ms per call, "
                          f"union {dev_v:.4f} ms; "
                          + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in each.items())
                          + f" | {card}", flush=True)

        xs = torch.as_tensor(smoke.synth_speech(32, 19200), device="cuda")
        high = pt.MelCepstralVocoder(cascade="fused",
                                     cascade_precision="HIGH", device="cuda",
                                     dtype=torch.float32)
        low = pt.MelCepstralVocoder(cascade="fused",
                                    cascade_precision="DEFAULT",
                                    device="cuda", dtype=torch.float32)
        mc = high.analyze(xs)
        for name, fn in (
                ("flagship HIGH analysis_synthesis",
                 lambda: high.analysis_synthesis(xs)),
                ("flagship DEFAULT synthesize",
                 lambda: low.synthesize(xs, mc))):
            calls = smoke.cuda_call_ms(torch, fn, 50)
            busy = smoke.profile_chain(torch, fn, 5)[0]
            print(f"[ab] {label} {name}: median {np.median(calls):.3f} ms, "
                  f"least {min(calls):.3f} ms per call (50 calls), device "
                  f"busy {busy:.3f} ms a call | {card}", flush=True)
        xs48 = torch.as_tensor(smoke.synth_speech(32, 57600, sr=48000),
                               device="cuda")
        kw48 = dict(frame_length=1200, frame_period=240, fft_length=2048,
                    cep_order=24, alpha=0.55, taylor_order=25,
                    cascade="fused", device="cuda", dtype=torch.float32)
        high = pt.MelCepstralVocoder(cascade_precision="HIGH", **kw48)
        low = pt.MelCepstralVocoder(cascade_precision="DEFAULT", **kw48)
        mc48 = high.analyze(xs48)
        for name, fn in (
                ("48 kHz HIGH analysis_synthesis",
                 lambda: high.analysis_synthesis(xs48)),
                ("48 kHz DEFAULT synthesize",
                 lambda: low.synthesize(xs48, mc48))):
            med = float(np.median(smoke.cuda_call_ms(torch, fn, 10)))
            print(f"[ab] {label} {name}: median {med:.3f} ms per call | "
                  f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
