#!/usr/bin/env python3
"""Time the batched SPD solve (B4), the first-order scan (B5) and the LPC
chain around them in one checkout of the port, so that two checkouts can
be compared in turns in one run.

    python3 tools/torch_solve_scan_ab.py [TREE [LABEL]]

TREE (default: this checkout) is the root of a checkout of the port: its
``diffsptk_tpu_torch`` is imported and its solve and scan kernels are
built.  It prints, each line ending with the card's name and power limit:
- B4 at the LPC analysis shapes (n=24, B=7,680): CUDA-event ms per call
  over 200 calls back to back, the kernel's own device ms (torch.profiler,
  20 calls), its share of the bound, and the wrapper's host time per step
  (``wrapper_steps``, chip_smoke.host_us: time.perf_counter_ns over 1,000
  calls each);
- B4's device ms at n = 13, 33, 48 and 64 (B=7,680);
- B5 at R=32, T=19,200, float32 and complex64: the same;
- B5 on one long row, T = 1,049,603 and 1,100,000 (1,026 and 1,075
  tiles of 1,024), float32 and complex64: per call and device ms, and
  the largest difference from the plain twin;
- at R=32, T=19,200, float32, the device ms of one elementwise pass over
  the same bytes (``torch.add(p, x, out=y)``: p and x read once, y
  written once) and of ``torch.cumsum``, neither of them the same
  function;
- the LPC chain (chip_smoke.lpc_chain, BASELINE.json configs[1]) at orders
  24 (``[lpc]``) and 1 (``[lpc1]``) on 32 x 19,200 samples of synthetic
  speech: the median CUDA-event ms of 20 calls, and the profiler's device
  busy ms and share of one call.
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


def wrapper_steps(torch, mod, a, b) -> dict:
    """The host work of the SPD solve (``mod`` kernels/solve.py; a = A,
    b = b) or scan (kernels/scan.py; a = p, b = x) wrapper, step by step:
    each entry repeats one step on the same inputs, and "call" is the whole
    wrapper.  A copy of the wrappers' steps, for this tool alone: the
    parent's wrapper (without ``build.launch``) has other steps, a second
    ctypes call and an allocation for the scan's scratch, and
    ``torch.cuda.device`` entered on every call."""
    import importlib

    pkg = mod.__name__.rsplit(".", 1)[0]
    build = importlib.import_module(pkg + ".build")
    use_twins = importlib.import_module(pkg + ".state").use_twins
    new = hasattr(build, "launch")
    dev = b.device
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = {}
    if hasattr(mod, "spd_solve_batched"):
        n = b.shape[-1]
        steps["checks"] = lambda: (mod._check_args(a, b), a.is_cuda,
                                   use_twins(), a.dtype != torch.float32)
        steps["layout"] = lambda: (a.contiguous(), b.contiguous())
        c_args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                  b.numel() // n)
        entry, call = mod._lib(), lambda: mod.spd_solve_batched(a, b)
    else:
        T = b.shape[-1]
        R = b.numel() // T
        steps["checks"] = lambda: (a.shape != b.shape, a.device != b.device
                                   or a.dtype != b.dtype, b.is_cuda,
                                   use_twins(), b.dtype not in mod.DTYPES)
        call = lambda: mod.first_order_scan(a, b)  # noqa: E731
        if new:
            tiles = R * -(-T // mod.TILE)
            steps["layout"] = lambda: (mod._dense(a), mod._dense(b))
            entry = mod._lib()[0][b.dtype]
            _, cap, ws = mod._workspace(dev, stream, tiles)
            steps["workspace"] = lambda: mod._workspace(dev, stream, tiles)
            c_args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), ws, cap,
                      R, T)
        else:
            steps["layout"] = lambda: tuple(
                t.resolve_conj().resolve_neg().contiguous() for t in (a, b))
            entry, size = mod._lib(b.dtype == torch.complex64)
            scratch = torch.empty(size(R, T), dtype=b.dtype, device=dev)
            steps["scratch size"] = lambda: size(R, T)
            steps["scratch"] = lambda: torch.empty(size(R, T), dtype=b.dtype,
                                                   device=dev)
            c_args = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), R, T)
    steps["output"] = lambda: torch.empty_like(b)
    steps["stream"] = lambda: torch.cuda.current_stream(dev).cuda_stream
    steps["pointers"] = lambda: (a.data_ptr(), b.data_ptr(), out.data_ptr())
    if new:
        steps["device"] = lambda: dev.index == torch.cuda.current_device()
    else:
        def device():
            with torch.cuda.device(dev):
                pass
        steps["device"] = device
    steps["C entry"] = lambda: entry(*c_args, stream)
    steps["call"] = call
    return steps


def host_breakdown(torch, smoke, mod, a, b) -> str:
    """``wrapper_steps``' host microseconds per call, each over 1,000
    calls, with their sum beside the whole call's."""
    us = {k: smoke.host_us(torch, fn) for k, fn in wrapper_steps(
        torch, mod, a, b).items()}
    whole = us.pop("call")
    return (", ".join(f"{k} {v:.2f}" for k, v in us.items())
            + f"; sum {sum(us.values()):.2f}, whole call {whole:.2f} us")


def scan_case(torch, rng, shape, dtype, dev):
    """p (|p| < 0.9) and x of ``shape`` on the card, float32 or complex64."""
    p = 0.9 * rng.uniform(-1, 1, shape)
    x = rng.standard_normal(shape)
    if dtype == torch.complex64:
        p = p * np.exp(1j * rng.uniform(0, 2 * np.pi, shape))
        x = x + 1j * rng.standard_normal(shape)
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (p, x))


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
    from diffsptk_tpu_torch.kernels import build, scan, solve

    smoke.check(pt.__file__.startswith(tree), f"imported {pt.__file__}")
    build.build(("spd_solve", "scan"))
    card = smoke.smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    n, B = 24, 7680
    A, b = (torch.as_tensor(a, device=dev)
            for a in smoke.spd_systems(B, n, seed=n))
    bound = smoke.bound_ms((n * (n + 1) // 2 + 2 * n) * B * 4.0,
                           B * (n ** 3 / 3 + 2 * n ** 2))[0]
    cases = [("B4", f"n={n} B={B}", solve, A, b, "spd_solve_kernel", bound)]
    rng = np.random.default_rng(31)
    R, T = 32, 19200
    for dtype, size in ((torch.float32, 4.0), (torch.complex64, 8.0)):
        p, x = scan_case(torch, rng, (R, T), dtype, dev)
        cases.append(("B5", f"R={R} T={T} {str(dtype)[6:]}", scan, p, x,
                      "scan_kernel", smoke.bound_ms(3 * R * T * size, 0.0)[0]))

    for name, shape, mod, a, c, kernel, bound in cases:
        fn = (mod.spd_solve_batched if mod is solve
              else mod.first_order_scan)
        call = smoke.cuda_ms(torch, lambda: fn(a, c), 200)
        own = smoke.kernel_device_ms(torch, lambda: fn(a, c), kernel)[0]
        share = f"{100 * bound / own:.1f} %" if own > 0 else "not measured"
        host = host_breakdown(torch, smoke, mod, a, c)
        print(f"[ab] {label} {name} {shape}: per call {call:.4f} ms, kernel "
              f"{own:.4f} ms ({share} of the bound {bound:.5f} ms); wrapper "
              f"host us per call: {host} | {card}", flush=True)

    line = []
    for n_ in (13, 33, 48, 64):
        A_, b_ = (torch.as_tensor(a, device=dev)
                  for a in smoke.spd_systems(B, n_, seed=n_))
        own = smoke.kernel_device_ms(
            torch, lambda: solve.spd_solve_batched(A_, b_),
            "spd_solve_kernel")[0]
        line.append(f"n={n_} {own:.4f}")
    print(f"[ab] {label} B4 device ms at B={B}: " + ", ".join(line)
          + f" | {card}", flush=True)

    p, x = cases[1][3], cases[1][4]
    y = torch.empty_like(x)
    add = smoke.kernel_device_ms(torch, lambda: torch.add(p, x, out=y), "")
    cumsum = smoke.kernel_device_ms(torch, lambda: torch.cumsum(p, -1), "")
    print(f"[ab] {label} float32 ({R}, {T}): one elementwise pass over the "
          f"same bytes (torch.add) {add[0]:.4f} ms, torch.cumsum "
          f"{cumsum[0]:.4f} ms of device time | {card}", flush=True)

    for T_ in (1049603, 1100000):
        for dtype, size in ((torch.float32, 4.0), (torch.complex64, 8.0)):
            p, x = scan_case(torch, rng, (1, T_), dtype, dev)
            err = float((scan.first_order_scan(p, x)
                         - scan.first_order_scan_plain(p, x)).abs().max())
            call = smoke.cuda_ms(torch, lambda: scan.first_order_scan(p, x),
                                 200)
            own = smoke.kernel_device_ms(
                torch, lambda: scan.first_order_scan(p, x), "scan_kernel")[0]
            bound = smoke.bound_ms(3 * T_ * size, 0.0)[0]
            print(f"[ab] {label} B5 R=1 T={T_} {str(dtype)[6:]}: per call "
                  f"{call:.4f} ms, kernel {own:.4f} ms ({100 * bound / own:.1f}"
                  f" % of the bound {bound:.5f} ms), |kernel-twin| {err:.3e}"
                  f" | {card}", flush=True)

    xs = torch.as_tensor(smoke.synth_speech(32, 19200), device=dev)
    with torch.no_grad():
        for tag, M in (("lpc", 24), ("lpc1", 1)):
            chain, _ = smoke.lpc_chain(torch, M, "cuda", torch.float32)
            med = float(np.median(smoke.cuda_call_ms(
                torch, lambda: chain(xs), 20)))
            prof = smoke.profile_chain(torch, lambda: chain(xs))
            print(f"[ab] {label} [{tag}] M={M}: median {med:.3f} ms per "
                  f"call, {smoke.busy_share(prof[0], prof[4])} | {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
