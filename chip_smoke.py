#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's chains and kernels on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card   -- require CUDA; print nvidia-smi's name and power limit;
  2. build  -- build every CUDA kernel from csrc/ with nvcc (sm_90a, one
               nvcc per source, all at once); print each source's nvcc
               time and ptxas' registers, shared memory and spills (for
               newton.cu, one instance per order, their range);
  3. K1     -- the Newton kernel against its plain twin and a float64
               solve at n=25, B=7,680; its backward against the twin's;
               its time per call and on the device, and the share of
               its bound; and at B=64, below the JAX package's batch gate,
               against float64 and against the port's plain solve;
  4. K2     -- the cascade kernel's chunked entry at the flagship
               geometry (B=32, N=240, P=80, M=199, S=20) against its
               folded twin and its direct plain version: time, bound,
               rate against the fp32 peak, tile, ptxas' registers and
               spills, and a grouped conv1d reference;
  5. K4     -- the SPD solve kernel against its twin at n = 13, 24, 33,
               64 and B=7,680, and its backward;
  6. K5     -- the scan kernel, float32 and complex64, against its twin
               at R=32, T=19,200 and at an odd T, and its backward;
  7. chain  -- MelCepstralVocoder(cascade="fused").analysis_synthesis on
               32 x 19,200 float32 samples: launch counts of the run, the
               kernel path against the twin path, a float64 CPU run of
               one row, the IMLSA cascade alone on the chain's own
               coefficients (kernel, twin and float64, its call's median
               time, busy share and gaps between its stages; line
               [imlsa]), SNR, the median and p90 time of 100 calls and
               samples/s at the median, and a torch.profiler breakdown
               of the device time of one call with the gaps between
               cascade stages;
  8. grad   -- one backward of the chain on a short batch;
  9. lpc    -- the LPC analysis-synthesis chain (BASELINE.json configs[1],
               M=24) on 32 x 19,200 samples: launch counts, the kernel
               path against the twin path, the LPC coefficients of every
               frame and y of row 0 against a float64 CPU run, SNR,
               timing and profile as for the chain;
 10. lpc1   -- the same chain at LPC order 1, which takes the scan kernel;
 11. lpc-grad -- one backward of the M=24 chain on 16 x 12,800 samples
               (2,560 systems), through the solve kernel's backward;
 12. K3     -- the same for the unchunked entry at B=32, N=240, S=20
               and (P, M) = (240, 199) and (80, 79);
 13. K6, K7, K8 -- the windowed gather, the overlap-add and the threefry
               draws against their twins at the shapes of every call site
               of [world] (recorded from one call), and the first two's
               backwards; each kernel's time per call and on the device,
               with its rate and share of the bound (the gather at each
               site and summed); for the overlap-add, the load that the
               slot table puts on its blocks, and the kernel against
               overlap_add_grouped, its computation in torch in the same
               order (bit for bit); for the draws, bits equal to the
               twin's and normals within rtol 1e-6;
 14. world  -- WorldVocoder(ap_algorithm="d4c").analysis_synthesis
               (BASELINE.json configs[3], YIN for its neural tracker) on
               32 x 19,200 float32 samples: launch counts, the kernel path
               against the twin path (the same random stream: JAX's
               threefry), row 0 against a float64 CPU run on the same
               noise (recorded), the log-energy and
               spectrogram correlations of y with x, the median and p90
               of 20 calls, the profiler's device breakdown and busy
               share, and the noise draws' device time;
 15. world-tandem -- the same with TANDEM, the model's default;
 16. world-grad -- one backward of the chain on 4 x 12,800 samples, through
               the gather's and the overlap-add's backwards;
 17. chain48 -- MelCepstralVocoder at 48 kHz with 5 ms frames (P=240,
               cascade="fused", Taylor order 25) on 32 x 57,600 samples,
               which takes the unchunked cascade entry; both float32
               paths against a float64 run on the card, SNR above 20 dB,
               the profiler's breakdown and the gaps between stages;
then one JSON line of per-kernel numbers, nvidia-smi's line, and the
result line.  Every time is CUDA-event time on this card.
"""

from __future__ import annotations

import json
import re
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


def profile_chain(torch, fn, calls: int = 3, stages: int = 0):
    """Device time per call of ``fn`` under torch.profiler: the busy time
    (the union of the device functions' intervals: kernels launched as
    programmatic dependents overlap), the eight costliest device functions
    by summed duration, the number of device functions run per call, and
    the gaps between the launches of the cascade kernel within each
    cascade of ``stages`` stages (``stage_gaps``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    device = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_name[evt.name] = (per_name.get(evt.name, 0.0)
                                  + evt.device_time / 1e3 / calls)
            device.append(evt)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return (union_us(device) / 1e3 / calls, [(k[:60], v) for k, v in top],
            len(device) / calls, stage_gaps(device, stages))


def kernel_device_ms(torch, fn, kernel: str, calls: int = 20):
    """Device ms per call of ``fn`` under torch.profiler (CUDA activity
    only): the kernel's own (device functions whose name holds
    ``kernel``), and the busy time of all that ``fn`` enqueues.  Unlike
    ``cuda_ms`` it leaves out the host's time between calls.  0.0 where
    the profiler recorded none of the kernel's launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    own = sum(e.device_time for e in events if kernel in e.name)
    return own / 1e3 / calls, union_us(events) / 1e3 / calls


def device_rate(nbytes: float, ms: float, bound: float) -> str:
    """A device time with its rate and share of the bound, or "not
    measured" where the profiler recorded nothing."""
    if ms <= 0.0:
        return "not measured"
    return (f"{ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s, "
            f"{100 * bound / ms:.1f} % of the bound")


def union_us(events) -> float:
    """Microseconds covered by at least one of ``events``' intervals."""
    total, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def stage_gaps(events, stages: int = 0) -> str:
    """The gaps between consecutive device functions that are both
    cascade stages (the kernel's ``stage_kernel``) of one cascade, from
    the end of one to the start of the next: their count and median in
    microseconds (negative where the next stage started early, as a
    programmatic dependent), and the idle part as a share of the stages'
    span.  With ``stages`` > 0, every stages-th stage kernel ends a
    cascade, and the gap after it (to the next call's first stage) does
    not count."""
    events = sorted(events, key=lambda e: e.time_range.start)
    gaps, done = [], 0
    for prev, nxt in zip(events, events[1:]):
        if "stage_kernel" not in prev.name:
            continue
        done += 1
        if "stage_kernel" in nxt.name and (stages <= 0 or done % stages):
            gaps.append(nxt.time_range.start - prev.time_range.end)
    if not gaps:
        return "no back-to-back cascade stages"
    busy = union_us([e for e in events if "stage_kernel" in e.name])
    idle = sum(g for g in gaps if g > 0)
    return (f"{len(gaps)} gaps between cascade stages, median "
            f"{float(np.median(gaps)):.2f} us, idle {idle:.2f} us in all, "
            f"{100 * idle / (idle + busy):.1f} % of the stages' span "
            f"({busy / 1e3:.3f} ms of stages)")


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
    device_ms, _, _, _ = profile_chain(
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
    device_ms, _, _, _ = profile_chain(
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
        busy_ms, top, n_device, _ = profile_chain(torch, lambda: chain(xs))
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



def cascade_bound(B: int, N: int, P: int, M: int, S: int):
    """The least work of an S-stage Taylor MLSA cascade (not the kernel's
    DFT-plan method): per frame and stage a (M+1)-tap FIR blended between
    the filters of frames n and n+1.  Directly that is 2 (M+1) 2 flops per
    sample; as an FFT convolution one real transform of the frame's
    L = P+M inputs and two inverse ones, at 2.5 L log2 L flops each, two
    complex products and the blend; plus one transform of each frame's c
    per call.  The lower count sets the bound, against x, y and c read or
    written once."""
    L = P + M
    rfft = 2.5 * L * np.log2(L)
    per_frame = min(2 * (M + 1) * 2 * P,
                    3 * rfft + 2 * 6 * (L // 2 + 1) + 3 * P)
    flops = B * N * (S * per_frame + rfft)
    return bound_ms((2 * B * N * P + B * N * (M + 1)) * 4.0, flops)


def cascade_case(torch, dev, B, N, P, M, S, seed):
    """x and coefficients that decay slowly enough for every tap to carry
    weight, with a stage gain near 1 (as [K2] draws them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N * P)).astype(np.float32)
    base = rng.standard_normal((B, 1, M + 1)) * (0.99 ** np.arange(M + 1))
    c = (base * (1 + 0.05 * rng.standard_normal((B, N, M + 1))) * 0.04)
    w = 1.0 / np.arange(1, S + 1)
    weights = torch.as_tensor(np.insert(w, 0, 1.0), dtype=torch.float32,
                              device=dev)
    a = torch.ones(S + 1, dtype=torch.float32, device=dev)
    return (torch.as_tensor(x, device=dev),
            torch.as_tensor(c.astype(np.float32), device=dev), weights, a)


def ptxas_summary(log: str, kernel: str) -> str:
    """ptxas' registers, stack and spills of each instance of ``kernel``
    in a build log (-Xptxas -v)."""
    out, name = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln
        elif kernel in name and ("spill" in ln or "Used" in ln):
            kind = "float4" if "ILb1E" in name else "scalar"
            out.append(f"{kind}: {ln.split(':', 1)[-1].strip()}")
    return "; ".join(out) or "not in the build log"


def ptxas_usage(log: str, kernel: str) -> dict:
    """Registers and spilled bytes (stores and loads) of each instance of
    ``kernel`` in a build log (-Xptxas -v), keyed by the instance's
    integer template argument, or by its mangled name if it has none."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            arg = re.search(r"ILi(\d+)E", name)
            key = (int(arg.group(1)) if arg else name) if kernel in name \
                else None
            if key is not None:
                out[key] = [0, 0]
        elif key is not None and "spill" in ln:
            out[key][1] = sum(map(int, re.findall(r"(\d+) bytes spill", ln)))
        elif key is not None and "Used" in ln:
            out[key][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def usage_line(usage: dict, pick=None) -> str:
    """One line of ``ptxas_usage``: the range of registers over the
    instances, the bytes they spill, and the instance ``pick``'s own."""
    if not usage:
        return "not in the build log"
    regs = [r for r, _ in usage.values()]
    line = (f"{len(usage)} instance{'s' if len(usage) > 1 else ''}, "
            f"{min(regs)}-{max(regs)} registers, "
            f"{sum(sp for _, sp in usage.values())} bytes spilled")
    if pick in usage:
        line += (f" (n={pick}: {usage[pick][0]} registers, "
                 f"{usage[pick][1]} bytes spilled)")
    return line


def conv_stage(torch, x, c, P: int, M: int):
    """One cascade stage (advance 0) as a grouped F.conv1d, every frame's
    filters c_n and c_{n+1} over its P+M inputs, plus the blend
    (torch.lerp): a reference of two calls, timed, never used by the
    port."""
    import torch.nn.functional as F

    B, N = c.shape[:2]
    c_hi = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    w = torch.stack([c.flip(-1), c_hi.flip(-1)], dim=2).reshape(
        B * N * 2, 1, M + 1)
    lam = torch.arange(P, dtype=x.dtype, device=x.device) / P

    def stage():
        ctx = F.pad(x, (M, 0)).unfold(-1, P + M, P).reshape(1, B * N, P + M)
        out = F.conv1d(ctx, w, groups=B * N).view(B, N, 2, P)
        return torch.lerp(out[:, :, 0], out[:, :, 1], lam)

    return stage


def check_cascade(torch, dev, card: str, tag: str, chunked: bool, B: int,
                  N: int, P: int, M: int, S: int, seed: int,
                  ptxas: str) -> tuple[dict, str]:
    """The cascade kernel through its chunked entry ([K2]) or its
    unchunked entry ([K3]) at (B, N, P, M, S): against the folded twin
    (bar 1e-5 of max|y|) and the direct plain version; the times of the
    kernel, the twin, the direct version and the grouped-conv1d
    reference; the bound, the direct work's rate against the fp32 peak,
    the tile and ptxas' registers and spills.  Returns the kernel line's
    numbers and the printed summary."""
    from diffsptk_tpu_torch.core import full_precision
    from diffsptk_tpu_torch.kernels import mlsa
    from diffsptk_tpu_torch.kernels.mlsa_cascade import (
        chunked_geometry,
        lane_aligned_nfft,
        taylor_cascade_direct,
        taylor_cascade_folded,
    )

    nfft = lane_aligned_nfft(2 * P + M + 1)
    geo = chunked_geometry(M, P, nfft)
    check((geo is not None) == chunked,
          f"{tag}: P={P}, M={M} is not the expected geometry")
    x, c, weights, a = cascade_case(torch, dev, B, N, P, M, S, seed=seed)
    xq = x.reshape(B, N, P)
    if chunked:
        def kernel():
            return mlsa.cascade_chunked_cuda(xq, c, weights, a, P, 0, geo[1])
    else:
        def kernel():
            return mlsa.cascade_unchunked_cuda(xq, c, weights, a, P, 0, nfft)
    kernel = full_precision(kernel)
    twin = full_precision(
        lambda: taylor_cascade_folded(x, c, weights, a, P, 0, nfft))
    direct = full_precision(
        lambda: taylor_cascade_direct(x, c, weights, a, P, 0))
    y_k = kernel().reshape(B, N * P)
    y_t, y_d = twin(), direct()
    torch.cuda.synchronize()
    scale = float(y_t.abs().max())
    err = float((y_k - y_t).abs().max())
    err_d = float((y_k - y_d).abs().max())
    check(err <= 1e-5 * scale,
          f"{tag} at P={P}, M={M} disagrees with its twin: {err} > 1e-5 * "
          f"{scale}")
    del y_k, y_t, y_d
    one = torch.ones(2, dtype=x.dtype, device=dev)
    conv = full_precision(conv_stage(torch, x, c, P, M))
    stage_d = taylor_cascade_direct(x, c, one, torch.tensor(
        [0.0, 1.0], device=dev), P, 0).reshape(B, N, P)
    err_conv = float((conv() - stage_d).abs().max())
    ms = cuda_ms(torch, kernel, 10)
    twin_ms = cuda_ms(torch, twin, 5)
    direct_ms = cuda_ms(torch, direct, 3, warm=1)
    conv_ms = cuda_ms(torch, conv, 10)
    bound, by = cascade_bound(B, N, P, M, S)
    work = 2 * (M + 1) * 2 * P * B * N * S
    rate = work / (ms * 1e-3)
    frames, threads, smem = mlsa.tile(P, M)
    summary = (f"P={P} M={M} S={S}: |kernel-twin| {err:.3e} (tol 1e-5 * "
               f"max|y| = {1e-5 * scale:.3e}), |kernel-direct| {err_d:.3e}; "
               f"kernel {ms:.4f} ms per call ({S} launches), bound "
               f"{bound:.4f} ms ({by}, {ms / bound:.1f}x); direct work "
               f"{work / 1e9:.3f} GFLOP at {rate / 1e12:.2f} TFLOP/s, "
               f"{100 * rate / F32_PEAK:.1f} % of the fp32 peak; tile "
               f"{frames} frames x {threads} threads, {smem} bytes of "
               f"shared memory; ptxas {ptxas}; twin {twin_ms:.3f} ms, "
               f"direct plain version {direct_ms:.3f} ms; reference, two "
               f"calls: grouped conv1d + lerp {conv_ms:.4f} ms per stage "
               f"({S * conv_ms:.3f} ms per {S}), |conv-direct| "
               f"{err_conv:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=twin_ms, bound_ms=bound,
                bound_by=by, library_ms=None), summary


def record_calls(module, name: str, sink: list):
    """Wrap ``module.name`` so that every call appends its arguments to
    ``sink``; returns a function that restores it."""
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        sink.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, spy)
    return lambda: setattr(module, name, orig)


def covered_samples(torch, T: int, starts, length: int) -> int:
    """Distinct samples of the (B, T) rows that the windows read, their
    indices clamped to [0, T-1] as the gather clamps them: the least input
    a gather at these starts must read."""
    lo = starts.long().clamp(0, T - 1)
    hi = (starts.long() + length - 1).clamp(0, T - 1)
    d = torch.zeros(starts.shape[0], T + 1, device=starts.device,
                    dtype=torch.int64)
    d.scatter_add_(1, lo, torch.ones_like(lo))
    d.scatter_add_(1, hi + 1, -torch.ones_like(hi))
    return int((d.cumsum(1)[:, :T] > 0).sum())


def check_gather(torch, sites, card: str, ptxas: str) -> dict:
    """[K6]: the gather kernel against its twin at every call site of one
    [world] call (exact: a copy), its backward, and the times of all the
    sites together and of each."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import gather

    ms = dev_ms = plain_ms = lib_ms = bound = nbytes = 0.0
    shapes, per_site = [], []
    for (x, starts, length), _ in sites:
        got = gather.gather_windows_cuda(x, starts, length)
        want = gather.gather_windows_plain(x, starts, length)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"K6 at {tuple(x.shape)}, {tuple(starts.shape)}, {length} is "
              f"not equal to its twin: {float((got - want).abs().max())}")
        idx = (starts[..., None].long() + torch.arange(
            length, device=x.device)).clamp(0, x.shape[-1] - 1)
        xe = x[:, None, :].expand(-1, idx.shape[1], -1)
        site_ms = cuda_ms(torch, lambda: gather.gather_windows_cuda(
            x, starts, length), 100)
        ms += site_ms
        site_dev = kernel_device_ms(torch, lambda: gather.gather_windows_cuda(
            x, starts, length), "gather_kernel")[0]
        dev_ms += site_dev
        plain_ms += cuda_ms(torch, lambda: gather.gather_windows_plain(
            x, starts, length), 20)
        lib_ms += cuda_ms(torch, lambda: torch.gather(xe, 2, idx), 100)
        b = (covered_samples(torch, x.shape[-1], starts, length)
             + starts.numel() + got.numel()) * 4.0
        nbytes += b
        bound += bound_ms(b, 0.0)[0]
        shapes.append(f"{tuple(x.shape)}x{length}")
        per_site.append(f"N={starts.shape[1]} L={length} {site_ms:.4f} ms "
                        f"per call, {b / site_ms / 1e9:.2f} TB/s; device "
                        + device_rate(b, site_dev, bound_ms(b, 0.0)[0]))
    # backward at the largest site, kernel (through the overlap-add kernel)
    # against the twin (index_add)
    (x, starts, length), _ = max(sites, key=lambda s: s[0][0].numel())
    xg = x.clone().requires_grad_(True)
    g = torch.randn(starts.shape + (length,), device=x.device,
                    generator=torch.Generator(x.device).manual_seed(3))
    gather.gather_windows(xg, starts, length).backward(g)
    d_k = xg.grad.clone()
    xg.grad = None
    with twins():
        gather.gather_windows(xg, starts, length).backward(g)
    err_grad = float((d_k - xg.grad).abs().max())
    scale = float(xg.grad.abs().max())
    check(err_grad <= 1e-5 * scale,
          f"K6 backward disagrees with the twin's: {err_grad}")
    print(f"[K6] {len(sites)} call sites of one [world] call ("
          + ", ".join(shapes) + f"): kernel equal to its twin at every "
          f"site; backward at {tuple(x.shape)} {err_grad:.3e} (tol 1e-5 * "
          f"max {scale:.3e}); all sites: kernel {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms, torch.gather on a prebuilt index "
          f"{lib_ms:.4f} ms, {nbytes / 1e6:.2f} MB, bound {bound:.5f} ms "
          f"(bytes), {100 * bound / ms:.1f} % of the bound reached, "
          f"{nbytes / ms / 1e9:.3f} TB/s; the kernel's device time "
          + device_rate(nbytes, dev_ms, bound) + "; per site: "
          + " | ".join(per_site)
          + f"; ptxas gather_kernel: {ptxas} | {card}", flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)


def ola_tile_stats(torch, tidx, L: int, out_len: int, group: int,
                   tile: int = 256) -> str:
    """The load that a slot table puts on the overlap-add's blocks.  For
    each output tile of ``tile`` samples: the slots whose window covers
    part of it (a block's serial chain in the one-pass design that owned
    a tile: mean and max), and the share of all response values read that
    the heaviest 5 % of tiles carry.  For the two-pass design (groups of
    ``group`` slots, csrc/ola.cu): the slots that one block of ``tile``
    workspace values walks, mean and max."""
    t = tidx.long().cpu()
    B, P = t.shape
    n_t = -(-out_len // tile)
    t0 = torch.arange(n_t) * tile
    lo = torch.searchsorted(t, (t0 - L + 1).expand(B, -1).contiguous())
    hi = torch.searchsorted(t, (t0 + tile).expand(B, -1).contiguous())
    walk = (hi - lo).double().reshape(-1)
    cover = torch.zeros(B, n_t * tile + L + 1, dtype=torch.int64)
    cover.scatter_add_(1, t, torch.ones_like(t))
    cover.scatter_add_(1, t + L, -torch.ones_like(t))
    values = cover.cumsum(1)[:, :n_t * tile].reshape(B, n_t, tile).sum(-1)
    values = values.double().reshape(-1)
    heavy = torch.argsort(walk, descending=True)[
        :max(1, round(0.05 * walk.numel()))]
    share = float(values[heavy].sum() / values.sum())
    G = -(-P // group)
    W = out_len + G * L
    w0 = torch.arange(-(-W // tile)) * tile
    chain = torch.zeros(B, w0.numel(), dtype=torch.int64)
    for g in range(G):
        s = t[:, g * group:(g + 1) * group].contiguous()
        t_lo = (w0 - g * L).expand(B, -1).contiguous()
        chain += (torch.searchsorted(s, t_lo + tile)
                  - torch.searchsorted(s, t_lo - L + 1))
    return (f"slots over each {tile}-sample output tile: mean "
            f"{float(walk.mean()):.1f}, max {float(walk.max()):.0f}, the "
            f"heaviest 5 % of tiles carry {100 * share:.1f} % of the "
            f"response values read; two passes ({G} groups of {group} "
            f"slots, workspace {B * W * 4 / 1e6:.2f} MB): a block walks "
            f"{float(chain.double().mean()):.1f} slots on average, at most "
            f"{int(chain.max())}")


def check_ola(torch, site, card: str) -> dict:
    """[K7]: the overlap-add kernel against its twin and against
    overlap_add_grouped (its computation in torch in its order, bit for
    bit) at the [world] call's shapes, its backward, times, and the load
    of the slot table on its blocks."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import ola

    (tidx, resp, out_len), _ = site
    B, P, L = resp.shape
    got = ola.overlap_add_cuda(tidx, resp, out_len)
    again = ola.overlap_add_cuda(tidx, resp, out_len)
    want = ola.overlap_add_plain(tidx, resp, out_len)
    grouped = ola.overlap_add_grouped(tidx, resp, out_len)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    # Each output sums up to a few tens of responses in float32 in another
    # order than index_add's, so the two differ by rounding: within 1e-5
    # of max|y|.  The kernel itself is deterministic, and equal to the
    # torch version of its order.
    check(err <= 1e-5 * scale,
          f"K7 disagrees with its twin: {err} > 1e-5 * {scale}")
    check(torch.equal(got, again), "K7 is not deterministic")
    check(torch.equal(got, grouped),
          f"K7 is not equal to overlap_add_grouped: "
          f"{float((got - grouped).abs().max())}")
    r = resp.clone().requires_grad_(True)
    g = torch.randn(B, out_len, device=resp.device,
                    generator=torch.Generator(resp.device).manual_seed(4))
    ola.overlap_add(tidx, r, out_len).backward(g)
    d_k = r.grad.clone()
    r.grad = None
    with twins():
        ola.overlap_add(tidx, r, out_len).backward(g)
    check(torch.equal(d_k, r.grad),
          "K7 backward (a gather) is not equal to the twin's")

    def kernel():
        return ola.overlap_add_cuda(tidx, resp, out_len)

    ms = cuda_ms(torch, kernel, 100)
    dev_ms, wrap_ms = kernel_device_ms(torch, kernel, "ola_")
    plain_ms = cuda_ms(torch, lambda: ola.overlap_add_plain(
        tidx, resp, out_len), 20)
    idx = (tidx[..., None].long() + torch.arange(L, device=resp.device)
           + out_len * torch.arange(B, device=resp.device)[:, None, None]
           ).reshape(-1)
    flat = resp.reshape(-1)

    def library():
        return torch.zeros(B * out_len, device=resp.device).scatter_add_(
            0, idx, flat)

    lib_ms = cuda_ms(torch, library, 100)
    nbytes = (resp.numel() + B * out_len) * 4.0 + tidx.numel() * 8.0
    bound, by = bound_ms(nbytes, float(resp.numel()))
    print(f"[K7] B={B} slots={P} L={L} out={out_len}: |kernel-twin| "
          f"{err:.3e} (tol 1e-5 * max|y| = {1e-5 * scale:.3e}), two kernel "
          f"runs equal, equal to overlap_add_grouped; backward equal to the "
          f"twin's; kernel {ms:.4f} ms per call, its two passes on the "
          f"device {device_rate(nbytes, dev_ms, bound)} (everything the "
          f"wrapper enqueues {wrap_ms:.4f} ms); twin {plain_ms:.4f} ms, "
          f"scatter_add_ on a prebuilt index {lib_ms:.4f} ms, "
          f"{nbytes / 1e6:.2f} MB, bound {bound:.5f} ms ({by}); "
          + ola_tile_stats(torch, tidx, L, out_len, ola.GROUP)
          + f" | {card}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def check_threefry(torch, sites, card: str) -> dict:
    """[K8]: the threefry kernel against its twin (utils/prng.py, on the
    card) at every draw of one [world] call: the windowed waveforms'
    dithers (flat draws under PRNGKey(0)) and the synthesis's slot noise.
    Bits equal; normals within rtol 1e-6 (the kernel's Horner steps fuse
    their multiply-adds, the twin's do not).  Times of all the draws
    together; bound from the output's bytes and the hashes' operations."""
    from diffsptk_tpu_torch.kernels import threefry
    from diffsptk_tpu_torch.utils import prng

    ms = dev_ms = plain_ms = bound = nbytes = ops = err = rel = 0.0
    shapes = []
    for kind, (args, _) in sites:
        if kind == "flat":
            key, shape, device = args
            n_keys, n = 0, int(np.prod(shape))
            in_bytes = 0.0

            def draw(bits=False, key=key, shape=shape, device=device):
                return threefry.normal_cuda(key, shape, device, bits=bits)

            def twin(bits=False, key=key, shape=shape, device=device):
                k = key.to(device)
                return (prng.bits(k, shape) if bits
                        else prng.normal(k, shape, torch.float32))
        else:
            seed, ti, span, offset, length = args
            n_keys = ti.numel()
            n = n_keys * length
            in_bytes = 8.0 * n_keys
            shape = (*ti.shape, length)

            def draw(bits=False, a=args):
                return threefry.slot_normal_cuda(*a, bits=bits)

            def twin(bits=False, a=args):
                seed, ti, span, offset, length = a
                if not bits:
                    return prng.slot_normal(*a, torch.float32)
                keys = prng.fold_in(prng.PRNGKey(seed, ti.device),
                                    prng.slot_counters(ti, span, offset))
                return prng.bits(keys, (length,))

        got_bits, want_bits = draw(True).long() & prng.MASK, twin(True)
        check(torch.equal(got_bits, want_bits),
              f"K8 {kind} {tuple(shape)}: bits differ from the twin's")
        got, want = draw(), twin()
        torch.cuda.synchronize()
        site_rel = float(((got - want).abs() / want.abs()).max())
        check(site_rel <= 1e-6,
              f"K8 {kind} {tuple(shape)}: normals {site_rel} from the "
              f"twin's (rtol 1e-6)")
        rel = max(rel, site_rel)
        err = max(err, float((got - want).abs().max()))
        ms += cuda_ms(torch, draw, 50)
        dev_ms += kernel_device_ms(torch, draw, "threefry")[0]
        plain_ms += cuda_ms(torch, twin, 3, warm=1)
        b = 4.0 * n + in_bytes
        o = threefry.operations(n, n_keys)
        nbytes += b
        ops += o
        bound += bound_ms(b, o)[0]
        shapes.append(f"{kind} {tuple(shape)}")
    by = bound_ms(nbytes, ops)[1]
    print(f"[K8] {len(sites)} draws of one [world] call ("
          + ", ".join(shapes) + f"): bits equal to the twin's, normals "
          f"within {rel:.3e} relative (tol 1e-6), max abs {err:.3e}; all "
          f"draws: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, library "
          f"none (torch.randn draws other numbers), {nbytes / 1e6:.2f} MB "
          f"out, {ops / 1e9:.3f} G operations, bound {bound:.5f} ms ({by}); "
          f"the kernel's device time {device_rate(nbytes, dev_ms, bound)} "
          f"| {card}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


class NoiseTape:
    """Records the random draws of a WORLD call (the windowed waveform's
    dither and the synthesis's slot noise) and replays row 0 of each, as
    float64 on the CPU, in the same order: a float64 CPU run of one row
    then sees the card's noise."""

    def __init__(self, torch, wc, synth):
        self.torch, self.wc, self.synth, self.tape = torch, wc, synth, []

    def record(self):
        dither, slot = self.wc.dither_noise, self.synth._slot_noise

        def rec(fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.tape.append(out)
                return out
            return wrapped

        self.wc.dither_noise = rec(dither)
        self.synth._slot_noise = rec(slot)
        return lambda: (setattr(self.wc, "dither_noise", dither),
                        delattr(self.synth, "_slot_noise"))

    def replay(self, synth64):
        dither = self.wc.dither_noise
        tape = iter(self.tape)

        def play(*args, **kwargs):
            return next(tape)[:1].to(device="cpu",
                                     dtype=self.torch.float64)

        self.wc.dither_noise = play
        synth64._slot_noise = play
        return lambda: setattr(self.wc, "dither_noise", dither)


def world_metrics(torch, xs, y):
    """Per-row correlation of log energy envelopes (STFT 400/80/512,
    tests/test_world.py) and the spectrogram correlation of row 0 in dB
    (bench_all.py)."""
    import diffsptk_tpu_torch as pt

    stft = pt.STFT(400, 80, 512, device=xs.device, dtype=xs.dtype)
    ex, ey = stft(xs).sum(-1), stft(y).sum(-1)
    lx, ly = torch.log(ex + 1e-8), torch.log(ey + 1e-8)
    lx, ly = lx - lx.mean(-1, keepdim=True), ly - ly.mean(-1, keepdim=True)
    r = (lx * ly).sum(-1) / torch.sqrt((lx * lx).sum(-1) * (ly * ly).sum(-1))
    sdb = pt.STFT(400, 80, 512, out_format="db", device=xs.device,
                  dtype=xs.dtype)
    Sx, Sy = sdb(xs[0]).double().cpu().numpy(), sdb(y[0]).double().cpu(
    ).numpy()
    return r.double().cpu().numpy(), float(np.corrcoef(Sx.ravel(),
                                                       Sy.ravel())[0, 1])


def run_world(torch, xs, card: str, ap_algorithm: str, tag: str,
              full: bool) -> tuple[dict, list, list, list]:
    """[world] / [world-tandem]: WorldVocoder on the card, float32.
    Returns the launch counts and the recorded gather, overlap-add and
    noise-draw call sites of one call."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import gather, ola, threefry
    from diffsptk_tpu_torch.ops import world_common as wc

    B, T = xs.shape
    voc = pt.WorldVocoder(ap_algorithm=ap_algorithm, device="cuda",
                          dtype=torch.float32)
    want = {"gather": {"d4c": 3 + 8, "tandem": 3 + 1}[ap_algorithm],
            "ola": 1,
            # dithers: CheapTrick 1, D4C 3 (two centroids, the smoothed
            # spectrum); the synthesis's slot noise 1
            "threefry": {"d4c": 1 + 3 + 1, "tandem": 1 + 1}[ap_algorithm]}
    gather_sites, ola_sites, flat, slots = [], [], [], []
    with torch.no_grad():
        gather.launches = ola.launches = threefry.launches = 0
        tape = NoiseTape(torch, wc, voc.synth)
        undo = [tape.record(),
                record_calls(gather, "gather_windows_cuda", gather_sites),
                record_calls(ola, "overlap_add_cuda", ola_sites),
                record_calls(threefry, "normal_cuda", flat),
                record_calls(threefry, "slot_normal_cuda", slots)]
        f0, ap, sp = voc.analyze(xs)
        y = voc.synthesize(f0, ap, sp, out_length=T)
        torch.cuda.synchronize()
        for u in undo:
            u()
        launches = {"gather": gather.launches, "ola": ola.launches,
                    "threefry": threefry.launches}
        check(launches == want,
              f"{tag}: launches {launches}, expected {want}")
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all()),
              f"{tag}: output is not finite or has the wrong shape")
        with twins():
            f0_p, ap_p, sp_p = voc.analyze(xs)
            y_p = voc.synthesize(f0_p, ap_p, sp_p, out_length=T)
        torch.cuda.synchronize()
        check(torch.equal(f0, f0_p), f"{tag}: f0 of the two paths differ")
        # The analysis differs only in the gathers (copies) and the
        # dithers' last bits: sp and ap must agree to rounding; y sums the
        # overlap-add in another order.
        err_sp = float(((sp - sp_p).abs() / sp_p.abs().amax(-1, True)).max())
        err_ap = float((ap - ap_p).abs().max())
        err_y = float((y - y_p).abs().max())
        y_scale = float(y_p.abs().max())
        check(err_sp <= 1e-5 and err_ap <= 1e-5,
              f"{tag}: sp ({err_sp}) or ap ({err_ap}) of the kernel path "
              f"disagrees with the twin path")
        check(err_y <= 1e-5 * y_scale,
              f"{tag}: y of the kernel path disagrees with the twin path: "
              f"{err_y} > 1e-5 * {y_scale}")
        r_env, r_spec = world_metrics(torch, xs, y)
        check(bool((r_env > 0.8).all()),
              f"{tag}: log-energy correlation below 0.8: {r_env.min()}")
        f64 = ""
        if full:
            voc64 = pt.WorldVocoder(ap_algorithm=ap_algorithm, device="cpu",
                                    dtype=torch.float64)
            # the card's noise: JAX's float64 stream draws other numbers
            # than its float32 one (other bits make each uniform)
            undo = tape.replay(voc64.synth)
            f0_64, ap_64, sp_64 = voc64.analyze(xs[:1].double().cpu())
            y64 = voc64.synthesize(f0_64, ap_64, sp_64, out_length=T)
            undo()
            f0_0 = f0[:1].double().cpu()
            both = (f0_0 > 0) & (f0_64 > 0)
            same_vuv = float(((f0_0 > 0) == (f0_64 > 0)).double().mean())
            err_f0 = float(((f0_0 - f0_64).abs() / f0_64.clamp(min=1))[both]
                           .max())
            check(same_vuv >= 0.98 and err_f0 <= 1e-4,
                  f"{tag}: f0 of row 0 against float64: voicing agrees on "
                  f"{same_vuv:.3f}, relative f0 error {err_f0}")
            d_ap = (ap[:1].double().cpu() - ap_64).abs()
            # D4C's smoothing keeps a float64-exact running sum, so float32
            # lands near float64 (a float32 running sum moved ap by 0.8).
            check(float(d_ap.max()) <= 1e-3,
                  f"{tag}: ap of row 0 is {float(d_ap.max())} from float64")
            d_sp = float(((sp[:1].double().cpu() - sp_64).abs()
                          / sp_64.abs().amax(-1, True)).max())
            d_y = float((y[:1].double().cpu() - y64).abs().max())
            r_ap = float(np.corrcoef(ap[:1].double().cpu().numpy().ravel(),
                                     ap_64.numpy().ravel())[0, 1])
            r_y = float(np.corrcoef(y[:1].double().cpu().numpy().ravel(),
                                    y64.numpy().ravel())[0, 1])
            f64 = (f"; row 0 against CPU float64 on the same noise: voicing "
                   f"agrees on {same_vuv:.4f} of frames, f0 where both "
                   f"voiced {err_f0:.3e} (tol 1e-4 relative), sp "
                   f"{d_sp:.3e} of each frame's max, ap max "
                   f"{float(d_ap.max()):.3e} (tol 1e-3), p95 "
                   f"{float(d_ap.quantile(0.95)):.3e}, correlation "
                   f"{r_ap:.4f}; y max {d_y:.3e} (max|y| "
                   f"{float(y64.abs().max()):.3f}), correlation {r_y:.4f}")
        calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs),
                             20 if full else 10)
        with twins():
            plain_ms = cuda_ms(torch, lambda: voc.analysis_synthesis(xs), 2,
                               warm=1)
    med = float(np.median(calls))
    p90 = float(np.percentile(calls, 90))
    prof = ""
    if full:
        busy_ms, top, n_device, _ = profile_chain(
            torch, lambda: voc.analysis_synthesis(xs))
        noise_ms = kernel_device_ms(
            torch, lambda: voc.analysis_synthesis(xs), "threefry", calls=3)[0]
        prof = (f"; device busy {busy_ms:.3f} ms ({100 * busy_ms / med:.1f} "
                f"%) in {n_device:.0f} device functions per call; noise "
                f"draws (threefry, {launches['threefry']} launches) "
                f"{noise_ms:.4f} ms of device time per call; top device "
                f"time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top))
    print(f"[{tag}] B={B} T={T}: launches {launches}; kernel path against "
          f"twin path: f0 equal, sp {err_sp:.3e} of each frame's max, ap "
          f"{err_ap:.3e} (tol 1e-5), y {err_y:.3e} (tol 1e-5 * {y_scale:.3f})"
          + f64 + f"; log-energy correlation with x per row: min "
          f"{r_env.min():.4f}, mean {r_env.mean():.4f} (bar 0.8); "
          f"spectrogram correlation of row 0 {r_spec:.4f}; median "
          f"{med:.3f} ms per call (p90 {p90:.3f}, {len(calls)} calls), "
          f"{B * T / (med * 1e-3):.1f} samples/s; twin path {plain_ms:.3f} "
          f"ms" + prof + f" | {card}", flush=True)
    noise = [("flat", c) for c in flat] + [("slot", c) for c in slots]
    return launches, gather_sites, ola_sites, noise


def world_grad(torch, xs, card: str) -> None:
    """[world-grad]: one backward of a loss on y with respect to x, f0
    detached, through the gather's and the overlap-add's backwards."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import gather, ola

    voc = pt.WorldVocoder(ap_algorithm="d4c", device="cuda",
                          dtype=torch.float32)
    xg = xs[:4, :12800].clone().requires_grad_(True)
    gather.launches = ola.launches = 0
    (voc.analysis_synthesis(xg) ** 2).sum().backward()
    torch.cuda.synchronize()
    counts = (gather.launches, ola.launches)
    # forward: 11 gathers and 1 overlap-add; backward: an overlap-add for
    # each gather and a gather for the overlap-add
    check(counts == (12, 12),
          f"[world-grad] launches (gather, ola) {counts}, expected (12, 12)")
    gmax = float(xg.grad.abs().max())
    check(bool(torch.isfinite(xg.grad).all()) and gmax > 0,
          "WORLD gradient is not finite or is zero")
    print(f"[world-grad] B=4 T=12800: gather launches {counts[0]}, "
          f"overlap-add launches {counts[1]} (forward 11 + 1, backward 1 + "
          f"11), finite, max|dL/dx| {gmax:.4e} | {card}", flush=True)


def run_chain48(torch, card: str) -> dict:
    """[chain48]: MelCepstralVocoder at 48 kHz, 5 ms frames, on the card:
    its 200-tap stages fit one frame period, so both cascades take the
    unchunked entry.  Taylor order 25: at alpha 0.55 the default order 20
    does not converge on this speech, in the JAX package as in the port
    (tests/test_torch_mlsa.py::test_mcep_vocoder_48k_taylor_order_matches_jax)."""
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import mlsa, newton

    B, T, S = 32, 57600, 25
    xs = torch.as_tensor(synth_speech(B, T, sr=48000), device="cuda")
    voc = MelCepstralVocoder(frame_length=1200, frame_period=240,
                             fft_length=2048, cep_order=24, alpha=0.55,
                             taylor_order=S, cascade="fused", device="cuda",
                             dtype=torch.float32)
    with torch.no_grad():
        newton.launches = mlsa.launches = mlsa.launches_unchunked = 0
        y = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches,
                    "mlsa_cascade": mlsa.launches,
                    "mlsa_cascade_unchunked": mlsa.launches_unchunked}
        check(launches == {"newton": 10, "mlsa_cascade": 0,
                           "mlsa_cascade_unchunked": 2 * S},
              f"[chain48] launches {launches}, expected Newton 10, "
              f"unchunked cascade {2 * S}, chunked 0")
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all()),
              "[chain48] output is not finite or has the wrong shape")
        with twins():
            y_p = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        err_y = float((y - y_p).abs().max())
        # Both float32 paths against a float64 run of all rows on the card
        # (float64 takes the twins).  At this spectrum's dynamic range the
        # Taylor terms of the cascades cancel heavily, and float32 rounding
        # grows to 1-3 % of max|y| in either path (in the plain twin on the
        # CPU too, whose mel-cepstra stay within 3e-6 of float64); so each
        # path is held to float64, not to the other.
        voc64 = MelCepstralVocoder(frame_length=1200, frame_period=240,
                                   fft_length=2048, cep_order=24, alpha=0.55,
                                   taylor_order=S, cascade="folded",
                                   device="cuda", dtype=torch.float64)
        y64 = voc64.analysis_synthesis(xs.double())

        def snr_db(a, b):
            a, b = a.double(), b.double()
            return float(10 * torch.log10((a ** 2).sum()
                                          / ((b - a) ** 2).sum()))

        snr_k64, snr_p64 = snr_db(y64, y), snr_db(y64, y_p)
        check(snr_k64 >= 30.0 and snr_p64 >= 30.0
              and snr_k64 >= snr_p64 - 3.0,
              f"[chain48] SNR against float64: kernel path {snr_k64:.2f} "
              f"dB, twin path {snr_p64:.2f} dB (bar 30 dB each, kernel at "
              f"most 3 dB below the twin)")
        snr, snr_p = snr_db(xs, y), snr_db(xs, y_p)
        snr_64 = snr_db(xs, y64)
        check(snr > 20.0 and snr_p > 20.0,
              f"[chain48] SNR of the kernel path {snr:.2f} dB, of the twin "
              f"path {snr_p:.2f} dB: too low")
        del y64
        calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs), 30)
        with twins():
            plain_ms = cuda_ms(torch, lambda: voc.analysis_synthesis(xs), 2,
                               warm=1)
    med = float(np.median(calls))
    p90 = float(np.percentile(calls, 90))
    with torch.no_grad():
        busy_ms, top, n_device, gaps = profile_chain(
            torch, lambda: voc.analysis_synthesis(xs), stages=S)
    print(f"[chain48] B={B} T={T} (48 kHz, P=240, Taylor order {S}): "
          f"launches {launches}; "
          f"SNR against a float64 run on the card: kernel path "
          f"{snr_k64:.2f} dB, twin path {snr_p64:.2f} dB (bar 30 dB, kernel "
          f"at most 3 dB below the twin); |y kernel-twin| {err_y:.3e}; SNR "
          f"against x: kernel path {snr:.2f} dB, twin path {snr_p:.2f} dB "
          f"(bar 20 dB), float64 {snr_64:.2f} dB; median {med:.3f} ms per "
          f"call (p90 {p90:.3f}, {len(calls)} calls), "
          f"{B * T / (med * 1e-3):.1f} samples/s; twin path {plain_ms:.3f} "
          f"ms; device busy {busy_ms:.3f} ms ({100 * busy_ms / med:.1f} %) "
          f"in {n_device:.0f} device functions per call; {gaps}; top device "
          f"time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
          + f" | {card}", flush=True)
    return launches


def main() -> int:
    import torch

    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import build, mlsa, newton
    from diffsptk_tpu_torch.kernels.mlsa_cascade import (
        lane_aligned_nfft,
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
    newton_ptxas = usage_line(
        ptxas_usage(logs.get("newton", ""), "newton_kernel"), pick=25)
    gather_ptxas = usage_line(
        ptxas_usage(logs.get("gather", ""), "gather_kernel"))
    for src, log in logs.items():
        took = (f"nvcc {build.seconds[src]:.1f} s; "
                if src in build.seconds else "")
        if src == "newton":   # one instance per order
            print(f"[build] newton: {took}newton_kernel {newton_ptxas}",
                  flush=True)
            continue
        keep = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"[build] {src}: {took}" + " | ".join(keep), flush=True)
    ptxas = ptxas_summary(logs.get("mlsa_cascade", ""), "stage_kernel")
    smem = {"newton": build.library("newton").newton_smem_bytes(25),
            "mlsa_cascade (P=80, M=199)": mlsa.tile(80, 199),
            "mlsa_cascade (P=240, M=199)": mlsa.tile(240, 199),
            "spd_solve (n=24)": build.library(
                "spd_solve").spd_solve_smem_bytes(24),
            "spd_solve (n=64)": build.library(
                "spd_solve").spd_solve_smem_bytes(64)}
    print(f"[build] done in {time.time() - t0:.1f} s; shared memory per "
          f"block at the flagship shapes (static for newton, dynamic for "
          f"the others; the cascade: frames, threads and bytes of its "
          f"tile): {smem}", flush=True)

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
    k1_dev = kernel_device_ms(torch, lambda: newton.newton_solve_lane_major(
        rt_t, b_t), "newton_kernel")[0]
    k1_plain = cuda_ms(torch, lambda: newton.newton_solve_plain(rt_t, b_t), 3,
                       warm=1)
    A32 = A64.float()
    b32 = b_t.T.contiguous()[..., None]
    k1_lib = cuda_ms(torch, lambda: torch.linalg.solve(A32, b32), 20)
    # Below the JAX package's batch gate (2,048 systems), which the port
    # does not keep (ops/mcep.py:_use_newton_kernel): the kernel against
    # float64 and against the solve the port would run without it.
    from diffsptk_tpu_torch.utils.linalg import spd_solve
    Bs = 64
    rt_s, b_s = rt_t[:, :Bs].contiguous(), b_t[:, :Bs].contiguous()
    x_s = newton.newton_solve_lane_major(rt_s, b_s)
    err_s = float((x_s.double() - x_64[:, :Bs]).abs().max())
    check(bool(torch.allclose(x_s.double(), x_64[:, :Bs], rtol=tol,
                              atol=tol)),
          f"K1 at B={Bs} disagrees with the float64 solve: {err_s}")
    A_s, bb_s = A64[:Bs].float(), b_s.T.contiguous()
    k1_small = cuda_ms(torch, lambda: newton.newton_solve_lane_major(
        rt_s, b_s), 200)
    k1_small_plain = cuda_ms(torch, lambda: spd_solve(A_s, bb_s), 50)
    k1_bytes = (2 * n - 1 + 2 * n) * B * 4.0
    k1_bound, k1_by = bound_ms(k1_bytes,
                               B * (n ** 3 / 3 + 2 * n ** 2))
    report["newton"] = dict(max_abs_err=err_twin, ms=k1_ms,
                            plain_ms=k1_plain, bound_ms=k1_bound,
                            bound_by=k1_by, library_ms=k1_lib)
    print(f"[K1] n={n} B={B}: |kernel-twin| {err_twin:.3e}, "
          f"|kernel-f64| {err_64:.3e}, backward {err_grad:.3e} "
          f"(tol {tol}); kernel {k1_ms:.4f} ms, twin {k1_plain:.3f} ms, "
          f"torch.linalg.solve {k1_lib:.4f} ms, bound {k1_bound:.5f} ms "
          f"({k1_by}), {100 * k1_bound / k1_ms:.2f} % of the bound "
          f"reached; the kernel's device time "
          f"{device_rate(k1_bytes, k1_dev, k1_bound)}; at B={Bs}: "
          f"|kernel-f64| {err_s:.3e}, kernel {k1_small:.4f} ms, the "
          f"port's plain solve {k1_small_plain:.4f} ms; ptxas "
          f"newton_kernel: {newton_ptxas} | {card}", flush=True)

    # 4. K2: the cascade kernel's chunked entry at the flagship geometry
    report["mlsa_cascade"], k2 = check_cascade(
        torch, dev, card, "K2", True, 32, 240, 80, 199, 20, 21, ptxas)
    print(f"[K2] B=32 N=240 {k2} | {card}", flush=True)

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
        S = 20                                # the model's Taylor order
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
        # so rounding is amplified.  Limits: kernel-twin within 2e-3
        # max|e| and the kernel's rms distance from float64 within 2x the
        # twin's (the DFT-plan kernel, summing 720 terms in one
        # accumulator, came to 1.42x; the direct FIR sums two 200-term
        # chains per output).  Then the cascade call's median time, device
        # busy share, the host's time to enqueue it and the gaps between
        # its 20 launches.
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
        im_calls = cuda_call_ms(torch, lambda: mlsa.taylor_cascade(
            *im_args, *geo), 50)
        im_ms = float(np.median(im_calls))
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        for _ in range(10):               # 200 launches: the queue holds them
            mlsa.taylor_cascade(*im_args, *geo)
        host_us = (time.perf_counter() - t_host) / 10 * 1e6
        torch.cuda.synchronize()
        im_busy, _, _, im_gaps = profile_chain(
            torch, lambda: mlsa.taylor_cascade(*im_args, *geo), calls=5,
            stages=S)
        print(f"[imlsa] B={Bv} N={mc.shape[-2]}: max sum|c| {c_sum:.3f}, "
              f"max|e| {e_scale:.4e}; |kernel-twin| {err_e:.3e} (tol 2e-3 "
              f"* max|e|); against float64: kernel max {max_k:.3e} rms "
              f"{rms_k:.3e}, twin max {max_p:.3e} rms {rms_p:.3e} (rms "
              f"ratio {rms_k / rms_p:.3f}, tol 2); cascade call median "
              f"{im_ms:.4f} ms (p90 {float(np.percentile(im_calls, 90)):.4f}"
              f", {len(im_calls)} calls), device busy {im_busy:.4f} ms "
              f"({100 * im_busy / im_ms:.1f} %); host enqueue "
              f"{host_us:.1f} us per call, {host_us / S:.2f} us per stage; "
              f"{im_gaps} | {card}", flush=True)
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
    busy_ms, top, n_device, gaps = profile_chain(
        torch, lambda: voc.analysis_synthesis(xs), stages=S)
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
          f"functions per call; {gaps}; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + f" | {card}",
          flush=True)

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

    # 12. K3: the cascade kernel's unchunked entry at the 48 kHz geometry
    #     (the main path's) and at P=80, M=79
    k3 = []
    for P3, M3 in ((240, 199), (80, 79)):
        row, line = check_cascade(torch, dev, card, "K3", False, 32, 240, P3,
                                  M3, 20, P3, ptxas)
        report.setdefault("mlsa_cascade_unchunked", row)
        k3.append(line)
    print("[K3] B=32 N=240 " + "; ".join(k3)
          + f"; library: none, no single PyTorch call | {card}", flush=True)

    # 14. and 13. the WORLD chain, then its kernels at its call sites
    xw = torch.as_tensor(synth_speech(32, 19200), device=dev)
    launches_w, gather_sites, ola_sites, noise_sites = run_world(
        torch, xw, card, "d4c", "world", full=True)
    report["gather"] = check_gather(torch, gather_sites, card,
                                    gather_ptxas)
    report["ola"] = check_ola(torch, ola_sites[0], card)
    report["threefry"] = check_threefry(torch, noise_sites, card)
    del gather_sites, ola_sites, noise_sites
    for key in ("gather", "ola", "threefry"):
        report[key]["launches"] = launches_w[key]

    # 15. and 16. TANDEM, and the gradient
    run_world(torch, xw, card, "tandem", "world-tandem", full=False)
    world_grad(torch, xw, card)

    # 17. the 48 kHz chain
    launches48 = run_chain48(torch, card)
    report["mlsa_cascade_unchunked"]["launches"] = launches48[
        "mlsa_cascade_unchunked"]

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
        "mlsa_cascade_unchunked": (
            "cuda", "diffsptk_tpu_torch/csrc/mlsa_cascade.cu",
            "diffsptk_tpu/kernels/pallas_mlsa.py:119"),
        "gather": ("cuda", "diffsptk_tpu_torch/csrc/gather.cu",
                   "diffsptk_tpu/kernels/pallas_gather.py:34"),
        "ola": ("cuda", "diffsptk_tpu_torch/csrc/ola.cu",
                "diffsptk_tpu/kernels/pallas_ola.py:26"),
        "threefry": ("cuda", "diffsptk_tpu_torch/csrc/threefry.cu",
                     "diffsptk_tpu/ops/world_common.py:293-298 and "
                     "diffsptk_tpu/ops/world_synth.py:128-143 "
                     "(jax.random.normal; not a Pallas kernel)"),
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
