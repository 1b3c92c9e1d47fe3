#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's chains and kernels on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card   -- require CUDA; print nvidia-smi's name and power limit;
  2. build  -- build every CUDA kernel from csrc/ with nvcc (sm_90a, one
               nvcc per source, all at once); print ptxas' registers,
               shared memory and spills;
  3. K1     -- the Newton kernel against its plain twin and a float64
               solve at n=25, B=7,680; its backward against the twin's;
  4. K2     -- the cascade kernel against its plain twin at the flagship
               geometry (B=32, N=240, P=80, M=199, S=20);
  5. K4     -- the SPD solve kernel against its twin at n = 13, 24, 33,
               64 and B=7,680, and its backward;
  6. K5     -- the scan kernel, float32 and complex64, against its twin
               at R=32, T=19,200 and at an odd T, and its backward;
  7. chain  -- MelCepstralVocoder(cascade="fused").analysis_synthesis on
               32 x 19,200 float32 samples: launch counts of the run, the
               kernel path against the twin path, a float64 CPU run of
               one row, the IMLSA cascade alone on the chain's own
               coefficients (kernel, twin and float64; line [imlsa]),
               SNR, the median and p90 time of 100 calls and
               samples/s at the median, and a torch.profiler breakdown
               of the device time of one call;
  8. grad   -- one backward of the chain on a short batch;
  9. lpc    -- the LPC analysis-synthesis chain (BASELINE.json configs[1],
               M=24) on 32 x 19,200 samples: launch counts, the kernel
               path against the twin path, the LPC coefficients of every
               frame and y of row 0 against a float64 CPU run, SNR,
               timing and profile as for the chain;
 10. lpc1   -- the same chain at LPC order 1, which takes the scan kernel;
 11. lpc-grad -- one backward of the M=24 chain on 16 x 12,800 samples
               (2,560 systems), through the solve kernel's backward;
then one JSON line of per-kernel numbers, nvidia-smi's line, and the
result line.  Every time is CUDA-event time on this card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

F32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, flop/s
HBM_RATE = 3.35e12    # H100 SXM device memory, bytes/s


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warm: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` in ms, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_call_ms(torch, fn, calls: int, warm: int = 3) -> list[float]:
    """CUDA-event time of each of ``calls`` calls of ``fn`` in ms, after
    warm-up.  Idle gaps on the card while the host catches up count."""
    for _ in range(warm):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda.synchronize()
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = flops / F32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_chain(torch, fn, calls: int = 3):
    """Device time per call of ``fn`` under torch.profiler: the busy sum,
    the eight costliest device functions by name, and the number of
    device functions run per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    count = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] = (per_name.get(evt.name, 0.0)
                                  + evt.device_time / 1e3 / calls)
            count += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return (sum(per_name.values()), [(k[:60], v) for k, v in top],
            count / calls)


def synth_speech(B: int, T: int, sr: int = 16000) -> np.ndarray:
    """Pulse trains with a gliding f0 through a fixed three-formant
    resonator plus 1e-3 white noise; one seed per row."""
    from scipy.signal import lfilter

    a = np.array([1.0])
    for f, bw in ((700.0, 130.0), (1220.0, 70.0), (2600.0, 160.0)):
        r = np.exp(-np.pi * bw / sr)
        a = np.convolve(a, [1.0, -2 * r * np.cos(2 * np.pi * f / sr), r * r])
    rows = []
    for b in range(B):
        rng = np.random.default_rng(1000 + b)
        f0 = np.linspace(rng.uniform(90, 140), rng.uniform(180, 260), T)
        phase = np.cumsum(f0 / sr)
        pulses = np.diff(np.floor(phase), prepend=0.0)
        x = lfilter([1.0], a, pulses)
        x = 0.5 * x / np.abs(x).max() + 1e-3 * rng.standard_normal(T)
        rows.append(x)
    return np.stack(rows).astype(np.float32)


def spd_systems(B: int, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """B well-conditioned SPD systems of order n, float32."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    return (A.astype(np.float32),
            rng.standard_normal((B, n)).astype(np.float32))


def check_spd_solve(torch, dev, card: str) -> dict:
    """[K4]: the SPD solve kernel against its twin across n at B=7,680,
    the backward at n=24, and times at the LPC shapes (n=24)."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import solve

    B = 7680
    errs = {}
    for n in (13, 24, 33, 64):
        A, b = (torch.as_tensor(a, device=dev)
                for a in spd_systems(B, n, seed=n))
        x_k = solve.spd_solve_batched(A, b)
        x_p = solve.spd_solve_plain(A, b)
        torch.cuda.synchronize()
        scale = float(x_p.abs().max())
        errs[n] = float((x_k - x_p).abs().max()) / scale
        check(errs[n] < 1e-4, f"K4 at n={n} disagrees with its twin: "
              f"{errs[n]} of max|x|")
        if n == 24:
            A24, b24, err24 = A, b, float((x_k - x_p).abs().max())
    Ag = A24.clone().requires_grad_(True)
    bg = b24.clone().requires_grad_(True)
    g = torch.cos(solve.spd_solve_plain(A24, b24))
    solve.spd_solve_diff(Ag, bg).backward(g)
    dA_k = Ag.grad + Ag.grad.transpose(-1, -2)
    db_k = bg.grad.clone()
    Ag.grad = bg.grad = None
    with twins():
        solve.spd_solve_diff(Ag, bg).backward(g)
    dA_p = Ag.grad + Ag.grad.transpose(-1, -2)
    err_grad = max(float((dA_k - dA_p).abs().max()),
                   float((db_k - bg.grad).abs().max()))
    check(bool(torch.allclose(dA_k, dA_p, rtol=1e-3, atol=1e-4))
          and bool(torch.allclose(db_k, bg.grad, rtol=1e-3, atol=1e-4)),
          f"K4 backward disagrees with the twin's: {err_grad}")
    n = 24
    ms = cuda_ms(torch, lambda: solve.spd_solve_batched(A24, b24), 200)
    plain = cuda_ms(torch, lambda: solve.spd_solve_plain(A24, b24), 5,
                    warm=1)

    def library():
        L = torch.linalg.cholesky(A24)
        return torch.cholesky_solve(b24[..., None], L)

    lib = cuda_ms(torch, library, 20)
    device_ms, _, _ = profile_chain(
        torch, lambda: solve.spd_solve_batched(A24, b24), 20)
    bound, by = bound_ms((n * (n + 1) // 2 + 2 * n) * B * 4.0,
                         B * (n ** 3 / 3 + 2 * n ** 2))
    print(f"[K4] B={B}: |kernel-twin| / max|x| "
          + ", ".join(f"n={k} {v:.3e}" for k, v in errs.items())
          + f" (tol 1e-4); backward at n=24 {err_grad:.3e} (rtol 1e-3, "
          f"atol 1e-4); at n=24: kernel {ms:.4f} ms (device time "
          f"{device_ms:.4f} ms), twin {plain:.3f} ms, "
          f"cholesky+cholesky_solve {lib:.4f} ms, bound {bound:.5f} ms "
          f"({by}) | {card}", flush=True)
    return dict(max_abs_err=err24, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib)


def check_scan(torch, dev, card: str) -> dict:
    """[K5]: the scan kernel, float32 and complex64, against its twin at
    R=32 and T = 19,200 and 19,199, the backward, and times at the LPC
    order-1 shapes (float32)."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import scan

    R = 32
    rng = np.random.default_rng(31)
    errs = {}
    cases = {}
    for dtype in (torch.float32, torch.complex64):
        tol = 2e-5 if dtype == torch.float32 else 1e-4
        for T in (19200, 19199):
            p = 0.9 * rng.uniform(-1, 1, (R, T))
            x = rng.standard_normal((R, T))
            if dtype == torch.complex64:
                p = p * np.exp(1j * rng.uniform(0, 2 * np.pi, (R, T)))
                x = x + 1j * rng.standard_normal((R, T))
            p, x = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (p, x))
            y_k = scan.first_order_scan(p, x)
            y_p = scan.first_order_scan_plain(p, x)
            torch.cuda.synchronize()
            key = (str(dtype)[6:], T)
            errs[key] = float((y_k - y_p).abs().max())
            check(bool(torch.allclose(y_k, y_p, rtol=tol, atol=tol)),
                  f"K5 {dtype} T={T} disagrees with its twin: {errs[key]}")
            cases[(dtype, T)] = (p, x)
    err_grad = 0.0
    for dtype in (torch.float32, torch.complex64):
        p, x = (t.clone().requires_grad_(True)
                for t in cases[(dtype, 19200)])
        g = torch.randn(p.shape, dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
        scan.scan_diff(p, x).backward(g)
        grads = p.grad.clone(), x.grad.clone()
        p.grad = x.grad = None
        with twins():
            scan.scan_diff(p, x).backward(g)
        for got, want in zip(grads, (p.grad, x.grad)):
            err_grad = max(err_grad, float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
                  f"K5 backward ({dtype}) disagrees with the twin's: "
                  f"{float((got - want).abs().max())}")
    p, x = cases[(torch.float32, 19200)]
    T = 19200
    ms = cuda_ms(torch, lambda: scan.first_order_scan(p, x), 200)
    plain = cuda_ms(torch, lambda: scan.first_order_scan_plain(p, x), 20)
    pc, xc = cases[(torch.complex64, 19200)]
    ms_c = cuda_ms(torch, lambda: scan.first_order_scan(pc, xc), 200)
    device_ms, _, _ = profile_chain(
        torch, lambda: scan.first_order_scan(p, x), 20)
    bound, by = bound_ms(3 * R * T * 4.0, 2.0 * R * T)
    bound_c, _ = bound_ms(3 * R * T * 8.0, 8.0 * R * T)
    print(f"[K5] R={R}: |kernel-twin| "
          + ", ".join(f"{k[0]} T={k[1]} {v:.3e}" for k, v in errs.items())
          + f" (tol 2e-5 float32, 1e-4 complex64); backward {err_grad:.3e} "
          f"(tol 1e-4); at T={T} float32: kernel {ms:.4f} ms (device "
          f"time of its three passes {device_ms:.4f} ms), twin "
          f"{plain:.3f} ms, bound {bound:.5f} ms ({by}); complex64: kernel "
          f"{ms_c:.4f} ms, bound {bound_c:.5f} ms; library: none, no "
          f"PyTorch call computes a first-order recurrence | {card}",
          flush=True)
    return dict(max_abs_err=max(v for k, v in errs.items()
                                if k[0] == "float32"),
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)


def lpc_chain(torch, M: int, device, dtype, eps=None):
    """configs[1] as bench_all.py builds it: frame + window -> LPC(M) ->
    norm0 -> all-zero inverse filter, then the all-pole resynthesis.
    Returns a function x -> (LPC coefficients, residual, resynthesis)
    and its three stages (analysis, inverse filter, resynthesis)."""
    import diffsptk_tpu_torch as pt

    P, L = 80, 400
    kw = dict(device=device, dtype=dtype)
    frame, window = pt.Frame(L, P, **kw), pt.Window(L, **kw)
    lpc = pt.LPC(L, M, eps=eps, **kw)
    zerodf, poledf = (pt.AllZeroDigitalFilter(M, P, **kw),
                      pt.AllPoleDigitalFilter(M, P, **kw))
    norm0 = pt.AllPoleToAllZeroDigitalFilterCoefficients(M, **kw)

    def analysis(xw):
        return lpc(window(frame(xw)))

    def inverse(xw, a):                       # inverse filter A(z)/K
        return zerodf(xw[..., :a.shape[-2] * P], norm0(a))

    def roundtrip(xw):
        a = analysis(xw)
        e = inverse(xw, a)
        return a, e, poledf(e, a)             # resynthesis K/A(z)

    return roundtrip, (analysis, inverse, poledf)


def run_lpc(torch, M: int, xs, card: str, tag: str) -> tuple[dict, float]:
    """[lpc] / [lpc1]: the LPC chain at order M on the card, float32."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import mlsa, newton, scan, solve

    B, T = xs.shape
    chain, (analysis, inverse, synthesis) = lpc_chain(torch, M, "cuda",
                                                      torch.float32)
    for mod in (newton, mlsa, solve, scan):
        mod.launches = 0
    with torch.no_grad():
        a, e, y = chain(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches, "mlsa_cascade": mlsa.launches,
                    "spd_solve": solve.launches, "scan": scan.launches}
        want = ({"spd_solve": 1, "scan": 0} if M > 12
                else {"spd_solve": 0, "scan": 1 if M == 1 else 0})
        for key, count in {"newton": 0, "mlsa_cascade": 0, **want}.items():
            check(launches[key] == count,
                  f"{tag}: {key} launched {launches[key]} times, "
                  f"expected {count}")
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all())
              and tuple(a.shape) == (B, T // 80, M + 1),
              f"{tag}: output is not finite or has the wrong shape")
        with twins():
            a_p, e_p, y_p = chain(xs)
        torch.cuda.synchronize()
        y_scale = float(y_p.abs().max())
        err_y = float((y - y_p).abs().max())
        check(err_y <= 1e-3 * y_scale,
              f"{tag}: y of the kernel path disagrees with the twin path: "
              f"{err_y} > 1e-3 * {y_scale}")
        # Against float64 on the CPU, with float32's eps of 1e-5 so that
        # only rounding separates the runs: the LPC coefficients of every
        # frame of every row (y is no check of them: the inverse filter
        # and the resynthesis share them, so y ~ x for any stable set),
        # and y of row 0.
        chain64, (analysis64, _, _) = lpc_chain(torch, M, "cpu",
                                                torch.float64, eps=1e-5)
        a64 = analysis64(xs.double().cpu())
        err_a = float((a.double().cpu() - a64).abs().max())
        err_a_p = float((a_p.double().cpu() - a64).abs().max())
        err_a_kp = float((a - a_p).abs().max())
        check(err_a <= 2 * err_a_p,
              f"{tag}: kernel LPC coefficients are {err_a} from float64, "
              f"more than 2x the twin's {err_a_p}")
        check(err_a_kp <= 2 * err_a_p,
              f"{tag}: kernel LPC coefficients are {err_a_kp} from the "
              f"twin's, more than 2x the twin's distance {err_a_p} from "
              f"float64")
        _, _, y64 = chain64(xs[:1].double().cpu())
        err_y64 = float((y[:1].double().cpu() - y64).abs().max())
        snr = float(10 * torch.log10((xs ** 2).sum()
                                     / ((y - xs) ** 2).sum()))
        check(snr > 30.0, f"{tag}: SNR {snr:.2f} dB is too low")
        calls = cuda_call_ms(torch, lambda: chain(xs), 100)
        with twins():
            plain_ms = cuda_ms(torch, lambda: chain(xs), 3, warm=1)
        busy_ms, top, n_device = profile_chain(torch, lambda: chain(xs))
        stages = {
            "analysis": lambda: analysis(xs),
            "inverse filter": lambda: inverse(xs, a),
            "resynthesis": lambda: synthesis(e, a)}
        stage_ms = {name: float(np.median(cuda_call_ms(torch, fn, 20)))
                    for name, fn in stages.items()}
    med = float(np.median(calls))
    p90 = float(np.percentile(calls, 90))
    print(f"[{tag}] M={M} B={B} T={T}: launches {launches}; |y kernel-twin| "
          f"{err_y:.3e} (tol 1e-3 * {y_scale:.3f}); LPC coefficients of "
          f"all {a.shape[0]} x {a.shape[1]} frames against CPU float64: "
          f"kernel path {err_a:.3e}, twin path {err_a_p:.3e} (tol 2x), "
          f"kernel-twin {err_a_kp:.3e} (tol 2x the twin's); y of row 0 "
          f"against CPU float64 {err_y64:.3e}; SNR {snr:.2f} dB; "
          f"median {med:.3f} ms per call (p90 {p90:.3f}, {len(calls)} "
          f"calls), {B * T / (med * 1e-3):.1f} samples/s; twin path "
          f"{plain_ms:.3f} ms; stages (median of 20): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items())
          + f"; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / med:.1f} %) in {n_device:.0f} device "
          f"functions per call; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + f" | {card}",
          flush=True)
    return launches, med


def main() -> int:
    import torch

    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.core import full_precision
    from diffsptk_tpu_torch.kernels import build, mlsa, newton
    from diffsptk_tpu_torch.kernels.mlsa_cascade import (
        chunked_geometry,
        lane_aligned_nfft,
        taylor_cascade_chunked,
        taylor_cascade_folded,
    )
    from diffsptk_tpu_torch.utils.linalg import remove_gain

    card = smi()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    t0 = time.time()
    logs = build.build()
    for src, log in logs.items():
        keep = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[build] {src}: " + " | ".join(keep), flush=True)
    smem = {"newton": build.library("newton").newton_smem_bytes(25),
            "mlsa_cascade": build.library(
                "mlsa_cascade").mlsa_cascade_smem_bytes(80, 128, 3, 3),
            "spd_solve (n=24)": build.library(
                "spd_solve").spd_solve_smem_bytes(24),
            "spd_solve (n=64)": build.library(
                "spd_solve").spd_solve_smem_bytes(64)}
    print(f"[build] done in {time.time() - t0:.1f} s; dynamic shared memory "
          f"per block at the flagship shapes: {smem} bytes", flush=True)

    report = {}

    # 3. K1: Newton solve at the analysis shapes
    n, B = 25, 7680
    rng = np.random.default_rng(7)
    rt = rng.standard_normal((2 * n - 1, B)).astype(np.float32) * 0.1
    rt[0] += 4.0 + n * 0.2
    b = rng.standard_normal((n, B)).astype(np.float32)
    rt_t = torch.as_tensor(rt, device=dev)
    b_t = torch.as_tensor(b, device=dev)
    x_k = newton.newton_solve_lane_major(rt_t, b_t)
    x_p = newton.newton_solve_plain(rt_t, b_t)
    i = np.arange(n)
    idx_t = torch.as_tensor(np.abs(i[:, None] - i[None, :]), device=dev)
    idx_h = torch.as_tensor(i[:, None] + i[None, :], device=dev)
    rt64 = rt_t.double().T
    A64 = rt64[:, idx_t] + rt64[:, idx_h]                    # (B, n, n)
    x_64 = torch.linalg.solve(A64, b_t.double().T[..., None])[..., 0].T
    torch.cuda.synchronize()
    err_twin = float((x_k - x_p).abs().max())
    err_64 = float((x_k.double() - x_64).abs().max())
    tol = 2e-4
    check(bool(torch.allclose(x_k, x_p, rtol=tol, atol=tol)),
          f"K1 disagrees with its twin: {err_twin}")
    check(bool(torch.allclose(x_k.double(), x_64, rtol=tol, atol=tol)),
          f"K1 disagrees with the float64 solve: {err_64}")
    rt_g = rt_t.clone().requires_grad_(True)
    b_g = b_t.clone().requires_grad_(True)
    g = torch.cos(x_p)
    newton.newton_solve_t(rt_g, b_g).backward(g)
    drt_k, db_k = rt_g.grad.clone(), b_g.grad.clone()
    rt_g.grad = b_g.grad = None
    with twins():
        newton.newton_solve_t(rt_g, b_g).backward(g)
    err_grad = max(float((drt_k - rt_g.grad).abs().max()),
                   float((db_k - b_g.grad).abs().max()))
    check(bool(torch.allclose(drt_k, rt_g.grad, rtol=tol, atol=tol))
          and bool(torch.allclose(db_k, b_g.grad, rtol=tol, atol=tol)),
          f"K1 backward disagrees with the twin's: {err_grad}")
    k1_ms = cuda_ms(torch, lambda: newton.newton_solve_lane_major(rt_t, b_t),
                    200)
    k1_plain = cuda_ms(torch, lambda: newton.newton_solve_plain(rt_t, b_t), 3,
                       warm=1)
    A32 = A64.float()
    b32 = b_t.T.contiguous()[..., None]
    k1_lib = cuda_ms(torch, lambda: torch.linalg.solve(A32, b32), 20)
    k1_bound, k1_by = bound_ms((2 * n - 1 + 2 * n) * B * 4.0,
                               B * (n ** 3 / 3 + 2 * n ** 2))
    report["newton"] = dict(max_abs_err=err_twin, ms=k1_ms,
                            plain_ms=k1_plain, bound_ms=k1_bound,
                            bound_by=k1_by, library_ms=k1_lib)
    print(f"[K1] n={n} B={B}: |kernel-twin| {err_twin:.3e}, "
          f"|kernel-f64| {err_64:.3e}, backward {err_grad:.3e} "
          f"(tol {tol}); kernel {k1_ms:.4f} ms, twin {k1_plain:.3f} ms, "
          f"torch.linalg.solve {k1_lib:.4f} ms, bound {k1_bound:.5f} ms "
          f"({k1_by}) | {card}", flush=True)

    # 4. K2: tap-chunked cascade at the flagship geometry
    Bc, N, P, M, S = 32, 240, 80, 199, 20
    nfft = lane_aligned_nfft(2 * P + M + 1)
    Q, nfft_c = chunked_geometry(M, P, nfft)
    K = nfft_c // 2 + 1
    rng = np.random.default_rng(21)
    x = rng.standard_normal((Bc, N * P)).astype(np.float32)
    # Coefficients that decay slowly enough for every tap chunk to carry
    # weight (the rms of each chunk is printed), with a stage gain near 1.
    base = rng.standard_normal((Bc, 1, M + 1)) * (0.99 ** np.arange(M + 1))
    c = (base * (1 + 0.05 * rng.standard_normal((Bc, N, M + 1))) * 0.04)
    chunk_rms = [float(np.sqrt(np.mean(c[..., j * P:(j + 1) * P] ** 2)))
                 for j in range(Q)]
    w = 1.0 / np.arange(1, S + 1)
    weights = torch.as_tensor(np.insert(w, 0, 1.0), dtype=torch.float32,
                              device=dev)
    a = torch.ones(S + 1, dtype=torch.float32, device=dev)
    x_t = torch.as_tensor(x, device=dev)
    c_t = torch.as_tensor(c.astype(np.float32), device=dev)

    def k2_kernel():
        return mlsa.cascade_chunked_cuda(x_t.reshape(Bc, N, P), c_t, weights,
                                         a, P, 0, nfft_c)

    def k2_plain():
        return taylor_cascade_chunked(x_t, c_t, weights, a, P, 0, nfft_c)

    y_k = full_precision(k2_kernel)().reshape(Bc, N * P)
    y_p = full_precision(k2_plain)()
    torch.cuda.synchronize()
    scale = float(y_p.abs().max())
    err_k2 = float((y_k - y_p).abs().max())
    tol2 = 1e-5
    check(err_k2 <= tol2 * scale,
          f"K2 disagrees with its twin: {err_k2} > {tol2} * {scale}")
    k2_ms = cuda_ms(torch, full_precision(k2_kernel), 10)
    k2_plain_ms = cuda_ms(torch, full_precision(k2_plain), 5)
    # The least work of a stage, not the kernel's DFT-plan method: per
    # frame a 200-tap FIR blended between the filters of frames n and n+1.
    # Directly that is 2 (M+1) 2 flops per sample; as an FFT convolution
    # one real transform of the frame's L = P+M inputs and two inverse
    # ones, at 2.5 L log2 L flops each, two complex products and the
    # blend; plus one transform of each frame's c per call.  The lower
    # count sets the bound.
    L = P + M
    rfft = 2.5 * L * np.log2(L)
    per_frame = min(2 * (M + 1) * 2 * P,
                    3 * rfft + 2 * 6 * (L // 2 + 1) + 3 * P)
    flops = Bc * N * (S * per_frame + rfft)
    k2_bound, k2_by = bound_ms((2 * Bc * N * P + Bc * N * (M + 1)) * 4.0,
                               flops)
    report["mlsa_cascade"] = dict(max_abs_err=err_k2, ms=k2_ms,
                                  plain_ms=k2_plain_ms, bound_ms=k2_bound,
                                  bound_by=k2_by, library_ms=None)
    print(f"[K2] B={Bc} N={N} P={P} M={M} S={S} Q={Q} K={K}: rms of c per "
          f"chunk {', '.join(f'{v:.3e}' for v in chunk_rms)}; "
          f"|kernel-twin| {err_k2:.3e} (tol {tol2} * max|y| = "
          f"{tol2 * scale:.3e}); kernel {k2_ms:.3f} ms per call "
          f"({S} launches), twin {k2_plain_ms:.3f} ms, bound "
          f"{k2_bound:.4f} ms ({k2_by}) | {card}", flush=True)

    # 5. K4 and 6. K5: the SPD solve and scan kernels
    report["spd_solve"] = check_spd_solve(torch, dev, card)
    report["scan"] = check_scan(torch, dev, card)

    # 7. the flagship chain
    Bv, T = 32, 19200
    xs = torch.as_tensor(synth_speech(Bv, T), device=dev)
    voc = MelCepstralVocoder(cascade="fused", device="cuda",
                             dtype=torch.float32)
    newton.launches = 0
    mlsa.launches = 0
    with torch.no_grad():
        y = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches, "mlsa_cascade": mlsa.launches}
        n_analyze = voc.mcep.n_iter
        check(launches["newton"] == n_analyze,
              f"Newton kernel launched {launches['newton']} times, "
              f"expected {n_analyze}")
        check(launches["mlsa_cascade"] == 2 * S,
              f"cascade kernel launched {launches['mlsa_cascade']} times, "
              f"expected {2 * S}")
        check(tuple(y.shape) == (Bv, T) and bool(torch.isfinite(y).all()),
              "chain output is not finite or has the wrong shape")
        mc = voc.analyze(xs)
        with twins():
            mc_p = voc.analyze(xs)
            y_p = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        err_mc = float((mc - mc_p).abs().max())
        err_y = float((y - y_p).abs().max())
        y_scale = float(y_p.abs().max())
        # A float32 round trip through 2 x 20 Taylor stages is good to
        # ~1e-3 of max|y| against float64 (the inverse filter's Taylor
        # series cancels, which amplifies rounding: see the IMLSA check
        # below), so two float32 paths are held to 1e-2.
        tol_y = 1e-2
        check(bool(torch.allclose(mc, mc_p, rtol=1e-4, atol=1e-4)),
              f"mc of the kernel path disagrees with the twin path: {err_mc}")
        check(err_y <= tol_y * y_scale,
              f"y of the kernel path disagrees with the twin path: {err_y}")
        # Both float32 paths against a float64 CPU run of the first row.
        voc64 = MelCepstralVocoder(cascade="folded", device="cpu",
                                   dtype=torch.float64)
        x1 = xs[:1, :3200]
        y64 = voc64.analysis_synthesis(x1.double().cpu())
        y1 = voc.analysis_synthesis(x1).double().cpu()
        with twins():
            y1_p = voc.analysis_synthesis(x1).double().cpu()
        err_64 = float((y1 - y64).abs().max())
        err_64_p = float((y1_p - y64).abs().max())
        scale_64 = float(y64.abs().max())
        check(err_64 <= tol_y * scale_64,
              f"card float32 chain disagrees with CPU float64: {err_64}")
        # The IMLSA cascade alone, on the chain's own stage coefficients:
        # kernel, twin and a float64 run of the same float32 inputs.  Its
        # Taylor terms (|c| sums to several units) far exceed the result,
        # so rounding is amplified; the kernel's longer accumulation chains
        # (240 and 256 FMAs per output against the twin's 80- and 128-term
        # matmuls) round about 1.4x as much in rms.  Limits: kernel-twin
        # within 2e-3 max|e| and the kernel's rms distance from float64
        # within 2x the twin's (about 9e-4 and 1.4x on an H100).
        stage = voc.imlsa.mglsadf.mglsadf
        c_im = remove_gain(stage.mgc2c(-mc), value=0.0)
        Pv = voc.frame_period
        geo = (Pv, stage.zerodf.padding[1],
               lane_aligned_nfft(2 * Pv + c_im.shape[-1]))
        im_args = (xs[..., :mc.shape[-2] * Pv], c_im, stage.weights, stage.a)
        e_k = mlsa.taylor_cascade(*im_args, *geo)
        e_p = taylor_cascade_folded(*im_args, *geo)
        e_64 = taylor_cascade_folded(*(t.double() for t in im_args), *geo)
        e_scale = float(e_64.abs().max())
        err_e = float((e_k - e_p).abs().max())
        d_k, d_p = (e.double() - e_64 for e in (e_k, e_p))
        max_k, max_p = (float(d.abs().max()) for d in (d_k, d_p))
        rms_k, rms_p = (float(d.pow(2).mean().sqrt()) for d in (d_k, d_p))
        c_sum = float(c_im.abs().sum(-1).max())
        check(err_e <= 2e-3 * e_scale,
              f"IMLSA kernel disagrees with its twin: {err_e}")
        check(rms_k <= 2 * rms_p,
              f"IMLSA kernel rounds {rms_k / rms_p:.2f}x the twin")
        print(f"[imlsa] B={Bv} N={mc.shape[-2]}: max sum|c| {c_sum:.3f}, "
              f"max|e| {e_scale:.4e}; |kernel-twin| {err_e:.3e} (tol 2e-3 "
              f"* max|e|); against float64: kernel max {max_k:.3e} rms "
              f"{rms_k:.3e}, twin max {max_p:.3e} rms {rms_p:.3e} (rms "
              f"ratio {rms_k / rms_p:.3f}, tol 2)", flush=True)
        snr = float(10 * torch.log10(
            (xs ** 2).sum() / ((y - xs) ** 2).sum()))
        check(snr > 20.0, f"round-trip SNR {snr:.2f} dB is too low")
        calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs), 100)
        chain_ms = float(np.median(calls))
        chain_p90 = float(np.percentile(calls, 90))
        with twins():
            chain_plain_ms = cuda_ms(
                torch, lambda: voc.analysis_synthesis(xs), 2, warm=1)
    rate = Bv * T / (chain_ms * 1e-3)
    busy_ms, top, n_device = profile_chain(
        torch, lambda: voc.analysis_synthesis(xs))
    for key, count in launches.items():
        report[key]["launches"] = count
    print(f"[chain] B={Bv} T={T}: launches {launches}; |mc kernel-twin| "
          f"{err_mc:.3e}; |y kernel-twin| {err_y:.3e} (tol {tol_y} * "
          f"{y_scale:.3f}); row 0 against CPU float64: kernel path "
          f"{err_64:.3e}, twin path {err_64_p:.3e} (tol {tol_y} * "
          f"{scale_64:.3f}); SNR {snr:.2f} dB; "
          f"median {chain_ms:.3f} ms per call (p90 {chain_p90:.3f}, "
          f"{len(calls)} calls), {rate:.1f} samples/s; twin path "
          f"{chain_plain_ms:.3f} ms | {card}", flush=True)

    print(f"[profile] device busy {busy_ms:.3f} ms of {chain_ms:.3f} ms per "
          f"call ({100 * busy_ms / chain_ms:.1f} %) in {n_device:.0f} device "
          f"functions per call; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top), flush=True)

    # 8. gradient through the chain
    xg = xs[:2, :3200].clone().requires_grad_(True)
    loss = (voc.analysis_synthesis(xg) ** 2).sum()
    loss.backward()
    grad = xg.grad
    gmax = float(grad.abs().max())
    check(bool(torch.isfinite(grad).all()) and gmax > 0,
          "chain gradient is not finite or is zero")
    print(f"[grad] B=2 T=3200: finite, max|dL/dx| {gmax:.4e}", flush=True)

    # 9. and 10. the LPC chain at orders 24 and 1
    xl = torch.as_tensor(synth_speech(32, 19200), device=dev)
    launches_lpc, _ = run_lpc(torch, 24, xl, card, "lpc")
    report["spd_solve"]["launches"] = launches_lpc["spd_solve"]
    launches_lpc1, _ = run_lpc(torch, 1, xl, card, "lpc1")
    report["scan"]["launches"] = launches_lpc1["scan"]

    # 11. gradient through the M=24 chain, through the solve's backward
    from diffsptk_tpu_torch.kernels import solve
    chain, _ = lpc_chain(torch, 24, "cuda", torch.float32)
    xg = xl[:16, :12800].clone().requires_grad_(True)
    solve.launches = 0
    (chain(xg)[2] ** 2).sum().backward()
    torch.cuda.synchronize()
    grad = xg.grad
    gmax = float(grad.abs().max())
    check(solve.launches == 2,
          f"[lpc-grad] solve kernel launched {solve.launches} times, "
          "expected 2 (forward and backward)")
    check(bool(torch.isfinite(grad).all()) and gmax > 0,
          "LPC chain gradient is not finite or is zero")
    print(f"[lpc-grad] B=16 T=12800 (2,560 systems): solve launches "
          f"{solve.launches}, finite, max|dL/dx| {gmax:.4e}", flush=True)

    kernels = []
    meta = {
        "newton": ("cuda", "diffsptk_tpu_torch/csrc/newton.cu",
                   "diffsptk_tpu/kernels/pallas_newton.py:44"),
        "mlsa_cascade": ("cuda", "diffsptk_tpu_torch/csrc/mlsa_cascade.cu",
                         "diffsptk_tpu/kernels/pallas_mlsa.py:260"),
        "spd_solve": ("cuda", "diffsptk_tpu_torch/csrc/spd_solve.cu",
                      "diffsptk_tpu/kernels/pallas_solve.py:34"),
        "scan": ("cuda", "diffsptk_tpu_torch/csrc/scan.cu",
                 "diffsptk_tpu/kernels/pallas_scan.py:66"),
    }
    for key, (route, source, replaces) in meta.items():
        r = report[key]
        kernels.append({
            "name": key, "route": route, "source": source,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
