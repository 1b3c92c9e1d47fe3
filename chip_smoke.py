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
               against float64 and against the port's plain solve; then
               its two-generator entry (mgcep's) the same way at n=24,
               B=7,680, and against its twin at n = 1, 12 and 33;
  4. K2     -- the cascade kernel's chunked entry at the flagship
               geometry (B=32, N=240, P=80, M=199, S=20) against its
               folded twin and its direct plain version: time, bound,
               rate against the fp32 peak, tile, ptxas' registers and
               spills, and a grouped conv1d reference;
  5. K4     -- the SPD solve kernel against its twin at n = 13, 24, 33,
               64 and, at its template edges, 1, 8, 9, 16, 17, 25, 32,
               40, 63, all at B=7,680, with each n's device time and
               share of the bound; an indefinite system gives NaN; its
               backward; at n=24 its times, and the host time of the
               wrapper and of its bare C entry (time.perf_counter_ns over
               1,000 calls each) with their difference;
  6. K5     -- the scan kernel, float32 and complex64, against its twin
               at R=32, T=19,200, an odd T and T=1, and at one row of
               more than 1,024 tiles (more than 32 groups of 32); two
               runs equal bit for bit; its backward; one device function
               per scan; its device time, tile and blocks, the host time
               of the wrapper and of its C entry, and torch.cumsum's time
               on the same float32 shape;
  6a. K9    -- the mcep residual kernel (the Newton step's residual of
               mel-cepstral analysis) against float64 and its float32
               twin at the benchmark's one-card shapes (n=25; 76,800 x
               257, 38,400 x 1,025, 153,600 x 257), at the Newton loop's
               first and sixth states, a ragged B, smcep's matrices and
               n = 1, 2, 12, 33; its backward; its time a step and on the
               device against the twin (the plain chain) and the addmm form;
  7. chain  -- MelCepstralVocoder(cascade="fused").analysis_synthesis on
               32 x 19,200 float32 samples: the mcep residual kernel's
               launches in one analyze call; launch counts of the run, the
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
               order (bit for bit); for the draws, bits and normals
               equal to the twin's bit for bit;
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
 18. pitch-fcnf0, pitch-crepe -- Pitch(out_format="f0") with FCNF0 and
               CREPE tiny on 32 x 19,200 samples at its default network
               precision (FCNF0 TF32, CREPE full fp32) and at the other:
               full fp32 against the port on the CPU (rows 0-1), TF32
               against full fp32 where TF32 is the default; cents against
               the known f0 glide, times, a stage split, the conv stack's
               rate against its peak and peak memory;
 19. world-fcnf0 -- [world] with FCNF0 (BASELINE.json configs[3] as
               bench_all.py names it): the same launches and bars, row 0's
               float64 CPU run analysing on the card's f0;
 20. straight -- STRAIGHT's envelope on [world-fcnf0]'s f0 against a
               float64 CPU run of row 0, and the time of its band split;
 21. excite -- ExcitationGeneration with Gaussian noise: one threefry
               launch, equal to the twin path within rtol 1e-6;
 22. istft  -- ISTFT(STFT(x)) at 400/80/512: SNR above 60 dB;
 23. battery -- bench_all.py's filterbank battery (BASELINE.json
               configs[4]: CQT -> ICQT, MDCT -> IMDCT, PQMF -> IPQMF,
               summed) on 8 x 76,800 samples: row 0 of each transform
               against the port's float64 run on the CPU (CQT and ICQT
               within 1e-3 of max, the others 1e-4), the IMDCT(MDCT(x))
               round trip above 90 dB and IPQMF(PQMF(x)) above 30 dB on the
               interior, the median and p90 of 50 calls, the busy share, a
               stage split and peak memory;
 24. battery-long -- the same on 8 x 28,800,000 samples (half an hour of
               16 kHz audio a channel, [battery]'s signal tiled): finite
               outputs, the round trips' bars over the whole length, the
               median of 5 calls, peak memory and busy share;
 25. mglsadf-modes -- MelCepstralVocoder with cascade="stages" (and
               "folded", the plain matmul-plan form beside it), and in
               mode "single-stage" and "freq-domain", on 32 x 19,200
               samples: Newton 10 launches, row 0 of the timed call, all
               19,200 samples, within 1e-2 of max|y| of float64 on the
               CPU, the median of 20 calls, busy share and peak memory;
 26. pade   -- MelCepstralVocoder(mode="pade-approx") on 32 x 3,200
               samples: the scan kernel 10 launches a call, all complex64,
               each of the ten scans over every row against its twin on
               its own inputs (1e-4), the output against the twin path
               (1e-2 of max|y|), row 0 within 1e-2 of float64 on the CPU,
               the per-sample loop's host time and the scan's device
               time;
 27. mgc    -- mel-generalized cepstral analysis-synthesis (mgc_chain:
               STFT -> mgcep with gamma = -1/3 -> the inverse and the
               forward MGLSA filter, cep_order 199, Taylor order 20, the
               fused cascade) on 32 x 19,200 samples: the Newton kernel's
               two-generator entry 11 launches a call, the cascade 40; mgc
               and y against the twin path (1e-4; 1e-2 of max|y|), row 0
               against float64 on the CPU (1e-2 of max|y|), SNR above 20
               dB, a gradient through the two-generator backward (22
               launches), the median and p90 of 20 calls, busy share and
               peak memory;
 28. analysis-rest -- smcep (one-generator Newton 10 launches), lpc2par /
               par2lpc, lpc2lsp / lsp2lpc, lsp2sp, fftcep, c2acr, c2mpir /
               mpir2c, the postfilter, mlsacheck, the polynomial roots (both
               methods) and the CSM pair once each on the card at the
               flagship's shapes, on the port's own outputs, each against
               float64 on the CPU within its bar, with no host read but
               the eig roots' stated host step;
 29. features -- MFCC and PLP at SPTK's command defaults (order 12, 20
               channels, lifter 22) and PLP at order 24 with 40 channels
               on the flagship's power spectrum: the SPD solve kernel 1
               launch a PLP-24 call (2 with its backward), the others
               none; each against the twin path (1e-4 of max) and row 0
               against float64 on the CPU; gradients; times, busy share
               and the kernel's device time at this call;
 30. gammatone -- gammatone analysis (30 bands at 16 kHz) then synthesis
               on 32 x 19,200 samples: the scan kernel exactly 4
               launches, complex64, each against its twin on its own
               inputs; the round trip's SNR; row 0 against float64 on the
               CPU; a gradient (8 launches); times, busy share, peak
               memory and the kernel's device time against its bound;
 31. griffin -- GriffinLim(400, 80, 512), 100 iterations, on [features]'
               spectrum: the initial phase equal to utils/prng.uniform's,
               the spectral convergence falling, the twin path; times;
 32. ops-rest -- the DCT family, chroma, DRC, companding, Delta, MLPG,
               the IIR and second-order filters and DTW once each at the
               flagship's shapes against float64 on the CPU, with no
               host read but DTW's stated host backtrack;
 33. learners -- VQ and two-stage VQ (codebook 256), the GMM (order 49, 32
               mixtures, full covariance in 25 x 25 blocks, LBG warm start,
               20 EM steps, regression), LBG (256 codewords in chunks of
               7,680 frames, twice, and float64 on the same draws), PCA,
               ICA of four mixed sources and NMF (64 components) on 76,800
               mel-cepstra of synthetic speech (ten flagship calls) and a
               power spectrum: float32 against float64 (LEARNER_BARS), the
               LBG's two runs taking the same decisions, the host reads of
               each fit against the stated ones, ms a step, busy shares;
 34. misc   -- the 15 misc modules once each at the flagship's shapes, no
               host read, row 0 against float64 on the CPU (MISC_BARS);
 35. functional -- the 100 stateless functions once each on small inputs,
               no host read, each equal to its class path; then mcep and
               smcep (the Newton kernel 10 launches a call), PLP-24,
               levdur and LPC at order 24 (the SPD solve kernel once) at
               the flagship's 32 x 240 frames;
 36. io     -- a wav and a checkpoint round trip, Throughput of the
               flagship call and a profiler trace;
 37. sharded -- the sharded classes (diffsptk_tpu_torch/parallel/)
               through an NCCL process group of world size 1 and a
               (1, 1) mesh, float32 at full width: the mel-cepstral
               vocoder (round trip, analysis, both synthesis halos) and
               WORLD with TANDEM (round trip, analysis, synthesis) on
               32 x 19,200, the all-pole filter (M 24, P 80) on the same,
               the six filterbanks on [battery]'s 8 x 76,800 and the
               data-parallel GMM on [learners]' 76,800 joint vectors;
               each against the one-rank class (SHARDED_BARS), its kernel
               launches (SHARDED_LAUNCHES: B1 and K9 10 an analysis;
               WORLD B6 4, B7 1, threefry 2), no host read but the GMM's
               one a step, the median ms a call and busy shares; the
               vocoder's row 0 within 1e-2 of max|y| of float64 on the
               CPU;
 38. sharded-multi -- with two cards or more, one NCCL rank a card on a
               (1, n) mesh, each class's unshard against one card at the
               same bars (the GMM also fitted in float64 on both sides);
               with one card, a line that says it did not run;
 39. sharded-train -- the JAX package's multi-chip training step
               (parallel/train.py, DryrunStep: the STFT with a learnable
               window, the MLSA synthesis with both halos, WORLD, the
               all-pole filter, the MDCT and PQMF round trips) through
               NCCL at world size 1, B=32, T=19,200, float32: 3 warm-up
               and 10 timed steps (median and p90 ms, busy share, peak
               memory), B6 4, B7 1 and threefry 2 launches a step, no
               host read, a split by term (forward, backward); the
               kernel path against twins() (loss, the gradients of
               window, mc and lpc) and rows 0-1 of mc's and lpc's
               gradients against a float64 CPU step, SHARDED_TRAIN_BARS;
               with two cards or more, n NCCL ranks on the dryrun's mesh
               against one card (else a line that says it did not run);
               then entry.dryrun_multichip(1) and its line;
 40. train-pitch -- the training paths (tools/torch_train_fcnf0.py,
               tools/torch_train_crepe_tiny.py) at their default batches:
               FCNF0 40 steps from init on the device corpus (the
               threefry kernel, 17 launches a step) and 10 resumed from
               the bundled checkpoint, CREPE-tiny 40 steps on host batches
               made before the timed window: ms a step, frames/s, busy
               share, peak memory, no host read, finite and falling
               losses; the corpus's draws equal to the twin's, its values
               within CORPUS32_BARS of float64; one step's gradients
               against the CPU twin's float64; the checkpoint through
               PitchExtractionByFCNF0 on the card, a finite f0;
 41. precision -- the cascade's reduced-precision arms, "HIGH" (bf16x3)
               and "DEFAULT" (one bf16 pass), on the tensor-core kernel
               (csrc/mlsa_cascade_tc.cu): each entry and arm at full width
               (chunked at the flagship's geometry, unchunked at P=240)
               against its twin in the same arithmetic, HIGH against the
               fp32 kernel, row 0 against float64 on the CPU; times,
               device times (each entry's forward, inverse and prologue
               kernels each, and their union), the twin's, the fp32
               kernel's and the same plan products as cuBLAS bf16 GEMMs,
               the bound at the bf16 tensor-core peak, the tiles (each
               entry's rows x columns, ring stages, shared memory, CTAs
               and waves); then the slice's path: the flagship
               MelCepstralVocoder(cascade="fused", cascade_precision=
               "HIGH") round trip (Newton 10, HIGH 40; SNR, against the
               fp32 kernel path), its synthesize at DEFAULT (20), the 48
               kHz vocoder at HIGH (unchunked HIGH 50) and its synthesize
               at DEFAULT (25);
 42. examples -- examples/torch_analysis_synthesis.py, torch_neural_pitch.py
               and torch_world_vocoder.py once each on the card;
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
TF32_CENTS = 10.0     # bar: a network's TF32 f0 against its full fp32 f0
HBM_RATE = 3.35e12    # H100 SXM device memory, bytes/s
# [battery-long]: one card's half of an hour of 8-channel 16 kHz audio
BATTERY_LONG_T = 28_800_000
# profile_chain's windows so far, and those it profiled a second time
# because the profiler recorded no device activity in the first
PROFILED = {"windows": 0, "again": 0}


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
    by summed duration, the number of device functions run per call, the
    gaps between the launches of the cascade kernel within each cascade
    of ``stages`` stages (``stage_gaps``), and the elapsed host time per
    call of the same profiled calls, from the first call's start to the
    card's end of the last.  The busy share is the busy time over that
    elapsed time (``busy_share``): both come from one window.  Only the
    card's activity is traced, not the host's operators, to keep the
    profiler's own host cost in that window small.  A window in which the
    profiler recorded no device activity at all is profiled once more,
    with a note: the profiler once dropped a short window's records while
    the card ran the kernels (a scan window of [K5]).  ``PROFILED``
    counts the windows and the second attempts; ``busy_share`` prints
    both."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    PROFILED["windows"] += 1
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        device = [evt for evt in prof.events()
                  if evt.device_type == torch.autograd.DeviceType.CUDA]
        if device or attempt:
            break
        PROFILED["again"] += 1
        print(f"[profile] the profiler recorded no device activity in "
              f"{calls} profiled calls; profiling them once more "
              f"({profiled_again()})", flush=True)
    per_name = {}
    for evt in device:
        per_name[evt.name] = (per_name.get(evt.name, 0.0)
                              + evt.device_time / 1e3 / calls)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return (union_us(device) / 1e3 / calls, [(k[:60], v) for k, v in top],
            len(device) / calls, stage_gaps(device, stages), wall_ms)


def profiled_again() -> str:
    """How many of ``profile_chain``'s windows so far it profiled twice."""
    return (f"{PROFILED['again']} of {PROFILED['windows']} profiler windows "
            f"so far profiled twice")


def busy_share(busy_ms: float, wall_ms: float) -> str:
    """The device-busy time of ``profile_chain`` against the elapsed time
    of the same profiled calls, unclamped, and ``profiled_again``."""
    return (f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms elapsed in "
            f"the same profiled calls ({100 * busy_ms / wall_ms:.1f} %; "
            f"{profiled_again()})")


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


def host_us(torch, fn, calls: int = 1000, batch: int = 100) -> float:
    """Host microseconds per call of ``fn``: time.perf_counter_ns over
    ``calls`` calls, in batches of ``batch`` with the card synchronised
    between them (outside the timing), so that a full launch queue does
    not hold the host."""
    fn()
    total = 0
    for _ in range(calls // batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(batch):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / calls / 1e3


def host_overhead(torch, mod, a, b) -> str:
    """Host microseconds per call of the SPD solve (``mod`` kernels/solve.py;
    a = A, b = b) or scan (kernels/scan.py; a = p, b = x) wrapper and of
    its bare C entry on the same inputs (``host_us``: 1,000 calls each),
    and their difference, the wrapper's own host work."""
    dev = b.device
    out = torch.empty_like(b)
    if hasattr(mod, "spd_solve_batched"):
        n = b.shape[-1]
        entry = mod._lib()
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n, b.numel() // n)
        call = lambda: mod.spd_solve_batched(a, b)  # noqa: E731
    else:
        T = b.shape[-1]
        R = b.numel() // T
        entries, nbytes = mod._lib()
        tiles = R * -(-T // mod.TILE)
        ws = torch.zeros(nbytes(tiles), dtype=torch.uint8, device=dev)
        entry = entries[b.dtype]
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(),
                tiles, R, T)
        call = lambda: mod.first_order_scan(a, b)  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    whole = host_us(torch, call)
    bare = host_us(torch, lambda: entry(*args, stream))
    return (f"whole call {whole:.2f}, C entry {bare:.2f}, the rest of the "
            f"wrapper {whole - bare:.2f}")


def check_spd_solve(torch, dev, card: str) -> dict:
    """[K4]: the SPD solve kernel against its twin across n at B=7,680
    (the orders it has an instance for and those it pads), each n's
    device time and share of the bound; an indefinite system; the
    backward at n=24; times and the wrapper's host work at the LPC shapes
    (n=24)."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import solve

    B = 7680
    errs, device = {}, {}
    for n in (13, 24, 33, 64, 1, 8, 9, 16, 17, 25, 32, 40, 63):
        A, b = (torch.as_tensor(a, device=dev)
                for a in spd_systems(B, n, seed=n))
        x_k = solve.spd_solve_batched(A, b)
        x_p = solve.spd_solve_plain(A, b)
        torch.cuda.synchronize()
        scale = float(x_p.abs().max())
        errs[n] = float((x_k - x_p).abs().max()) / scale
        check(errs[n] < 1e-4, f"K4 at n={n} disagrees with its twin: "
              f"{errs[n]} of max|x|")
        own = kernel_device_ms(torch, lambda: solve.spd_solve_batched(A, b),
                               "spd_solve_kernel")[0]
        bound = bound_ms((n * (n + 1) // 2 + 2 * n) * B * 4.0,
                         B * (n ** 3 / 3 + 2 * n ** 2))[0]
        device[n] = (own, bound)
        if n == 24:
            A24, b24, err24 = A, b, float((x_k - x_p).abs().max())
    A = torch.eye(24, device=dev).repeat(64, 1, 1)
    A[:, 0, 0] = -1.0
    x = solve.spd_solve_batched(A, torch.ones(64, 24, device=dev))
    check(bool(torch.isnan(x[:, 0]).all()),
          "K4 gives no NaN for an indefinite system")
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
    device_ms, bound = device[n]
    by = bound_ms((n * (n + 1) // 2 + 2 * n) * B * 4.0,
                  B * (n ** 3 / 3 + 2 * n ** 2))[1]
    host = host_overhead(torch, solve, A24, b24)
    print(f"[K4] B={B}: |kernel-twin| / max|x| "
          + ", ".join(f"n={k} {v:.3e}" for k, v in errs.items())
          + f" (tol 1e-4); indefinite system gives NaN; backward at n=24 "
          f"{err_grad:.3e} (rtol 1e-3, atol 1e-4); kernel device ms (share "
          f"of the bound): "
          + ", ".join(f"n={k} {v[0]:.4f} ({100 * v[1] / v[0]:.1f} %)"
                      if v[0] > 0 else f"n={k} not measured"
                      for k, v in sorted(device.items()))
          + f"; at n=24: kernel {ms:.4f} ms per call (device time "
          f"{device_ms:.4f} ms), twin {plain:.3f} ms, "
          f"cholesky+cholesky_solve {lib:.4f} ms, bound {bound:.5f} ms "
          f"({by}); host us per call: {host} | {card}", flush=True)
    return dict(max_abs_err=err24, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib)


def check_scan(torch, dev, card: str) -> dict:
    """[K5]: the scan kernel, float32 and complex64, against its twin at
    R=32 and T = 19,200, 19,199 and 1, and at one row of more than 1,024
    tiles; two runs equal bit for bit; the backward; one device function
    per scan; times and the wrapper's host work at the LPC order-1 shapes
    (float32), beside torch.cumsum's one pass over the same shape."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import scan

    R = 32
    long_T = 1074 * scan.TILE + 3
    rng = np.random.default_rng(31)
    errs = {}
    cases = {}
    for dtype in (torch.float32, torch.complex64):
        tol = 2e-5 if dtype == torch.float32 else 1e-4
        for rows, T in ((R, 19200), (R, 19199), (R, 1), (1, long_T)):
            p = 0.9 * rng.uniform(-1, 1, (rows, T))
            x = rng.standard_normal((rows, T))
            if dtype == torch.complex64:
                p = p * np.exp(1j * rng.uniform(0, 2 * np.pi, (rows, T)))
                x = x + 1j * rng.standard_normal((rows, T))
            p, x = (torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in (p, x))
            y_k = scan.first_order_scan(p, x)
            y_p = scan.first_order_scan_plain(p, x)
            torch.cuda.synchronize()
            key = (str(dtype)[6:], T)
            errs[key] = float((y_k - y_p).abs().max())
            check(bool(torch.allclose(y_k, y_p, rtol=tol, atol=tol)),
                  f"K5 {dtype} T={T} disagrees with its twin: {errs[key]}")
            if T in (19200, long_T):
                check(bool(torch.equal(y_k, scan.first_order_scan(p, x))),
                      f"K5 {dtype} T={T}: two runs differ")
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
    n_device = profile_chain(
        torch, lambda: scan.first_order_scan(p, x), 20)[2]
    if n_device != 1:
        # The profiler has dropped a record of a window now and then
        # (0.95 functions a scan once, 19 records of 20 calls): profile
        # it once more, counted with the empty windows.
        PROFILED["again"] += 1
        print(f"[K5] the profiler recorded {n_device} device functions a "
              f"scan; profiling once more ({profiled_again()})", flush=True)
        n_device = profile_chain(
            torch, lambda: scan.first_order_scan(p, x), 20)[2]
    check(n_device == 1, f"K5: a scan ran {n_device} device functions, "
          "expected 1")
    device_ms = kernel_device_ms(torch, lambda: scan.first_order_scan(p, x),
                                 "scan_kernel")[0]
    device_c = kernel_device_ms(torch, lambda: scan.first_order_scan(pc, xc),
                                "scan_kernel")[0]
    cumsum = cuda_ms(torch, lambda: torch.cumsum(p, -1), 200)
    bound, by = bound_ms(3 * R * T * 4.0, 2.0 * R * T)
    bound_c, _ = bound_ms(3 * R * T * 8.0, 8.0 * R * T)
    host = host_overhead(torch, scan, p, x)
    print(f"[K5] R={R}: |kernel-twin| "
          + ", ".join(f"{k[0]} T={k[1]} {v:.3e}" for k, v in errs.items())
          + f" (tol 2e-5 float32, 1e-4 complex64; T={long_T} is one row of "
          f"{-(-long_T // scan.TILE)} tiles); two runs equal bit for bit; "
          f"backward {err_grad:.3e} (tol 1e-4); at T={T} float32: tile "
          f"{scan.TILE} samples, {R * -(-T // scan.TILE)} blocks, "
          f"{n_device:.0f} device function per scan ({profiled_again()}); "
          f"kernel {ms:.4f} ms "
          f"per call, device {device_rate(3 * R * T * 4.0, device_ms, bound)}"
          f"; twin {plain:.3f} ms, bound {bound:.5f} ms ({by}); complex64: "
          f"kernel {ms_c:.4f} ms per call, device "
          f"{device_rate(3 * R * T * 8.0, device_c, bound_c)}, bound "
          f"{bound_c:.5f} ms; host us per call: {host}; "
          f"torch.cumsum over float32 ({R}, {T}), a one-pass scan of this "
          f"shape and not the same function, {cumsum:.4f} ms; library: "
          f"none, no PyTorch call computes a first-order recurrence | {card}",
          flush=True)
    return dict(max_abs_err=max(v for k, v in errs.items()
                                if k[0] == "float32"),
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None)


# [K9]'s shapes, the benchmark's one-card cells: (frame length, period,
# FFT length, alpha, sample rate, rows, samples a row), n = 25.
RESIDUAL_CELLS = {
    "mcep16k.resynth": (400, 80, 512, 0.42, 16000, 128, 48000),
    "mcep48k.resynth": (1200, 240, 2048, 0.55, 48000, 64, 144000),
    "mcep16k.extract": (400, 80, 512, 0.42, 16000, 256, 48000),
}
# [K9]'s bar: the error from float64, of max|rt| (tests/test_torch_gpu.py's
# RESIDUAL_BAR).  ra = rt[:n] - av cancels as the iteration converges, so
# ra's own maximum is no scale; its gap over it is printed beside.
RESIDUAL_BAR = 1e-5


def residual_work(n: int, B: int, F: int) -> tuple[float, float]:
    """(operations, bytes) of one residual step: (6n + 1) F a frame (2n F
    for D, 3 F for the scale, the subtract and the exp, 2(2n-1) F for
    rt); log|X|^2 read once, mc read, rt and ra written."""
    return float((6 * n + 1) * F * B), float(4 * B * (F + 4 * n - 1))


def check_mcep_residual(torch, dev, card: str, ptxas: str) -> dict:
    """[K9]: the mcep residual kernel against float64 and its float32
    twin at the benchmark's three one-card shapes (n=25), at the Newton
    loop's first state and its sixth (five plain steps in), at a ragged B,
    with smcep's matrices and at n = 1, 2, 12, 33; its backward against
    the twin's; at each shape the kernel's time a step (CUDA events and
    device), the twin's (the plain chain of two GEMMs, the subtract from
    the transposed view of log|X|^2, the exp) and the one-line form
    (log|X|^2 made contiguous once, the subtract folded into the first
    GEMM by addmm), and the bound."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import mcep_residual as mr
    from diffsptk_tpu_torch.kernels.newton import newton_solve_t

    def gaps(got, want):
        """Each output's error over max|rt|, and ra's over max|ra|."""
        scale = float(want[0].abs().max())
        errs = [float((g.double() - w).abs().max())
                for g, w in zip(got, want)]
        return max(errs) / scale, errs[1] / float(want[1].abs().max())

    rows = {}

    def hold(what, args):
        before = mr.launches
        got = mr.mcep_residual_lane_major(*args)
        torch.cuda.synchronize()
        check(mr.launches == before + 1,
              f"K9 {what}: {mr.launches - before} launches, expected 1")
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"K9 {what}: the kernel's output is not finite")
        want = mr.mcep_residual_plain(*(a.double() for a in args))
        k, k_ra = gaps(got, want)
        t, t_ra = gaps(mr.mcep_residual_plain(*args), want)
        check(k < RESIDUAL_BAR, f"K9 {what}: the kernel is {k:.3e} of "
              f"max|rt| from float64 (bar {RESIDUAL_BAR})")
        rows[what] = (k, t, k_ra, t_ra)

    speech = {16000: synth_speech(256, 48000, 16000),
              48000: synth_speech(64, 144000, 48000)}
    times, result = [], None
    for cell, (frame, period, nfft, alpha, sr, B_rows, T) in \
            RESIDUAL_CELLS.items():
        x = torch.as_tensor(speech[sr][:B_rows], device=dev)
        kw = dict(fft_length=nfft, cep_order=24, alpha=alpha, n_iter=1,
                  device=dev, dtype=torch.float32)
        op = pt.MelCepstralAnalysis(**kw)
        with torch.no_grad():
            sp = pt.STFT(frame, period, nfft, out_format="power", device=dev,
                         dtype=torch.float32)(x)
            lx = torch.log(sp).reshape(-1, nfft // 2 + 1).contiguous()
            del x, sp
            P1, P2, av = op.P1, op.P2, op.alpha_vector
            n, (B, F) = av.shape[0], lx.shape
            mc0 = torch.matmul(lx, op.P0).T.contiguous()
            mc = mc0
            for _ in range(5):
                rt, ra = mr.mcep_residual_plain(mc, lx, P1, P2, av)
                mc = mc + newton_solve_t(rt, ra)
            hold(f"{cell} first state", (mc0, lx, P1, P2, av))
            hold(f"{cell} sixth state", (mc.contiguous(), lx, P1, P2, av))
            if cell == "mcep16k.resynth":
                cut = B - 37
                hold(f"{cell} ragged B={cut}",
                     (mc0[:, :cut].contiguous(), lx[:cut].contiguous(), P1,
                      P2, av))
            sm = pt.SecondOrderAllPassMelCepstralAnalysis(theta=0.1, **kw)
            hold(f"{cell} smcep's matrices",
                 (torch.matmul(lx, sm.P0).T.contiguous(), lx, sm.P1, sm.P2,
                  sm.alpha_vector))
            args = (mc0, lx, P1, P2, av)
            lx_c, P1_t, P2_t = lx.T.contiguous(), P1.T, P2.T

            def addmm():
                d = torch.exp(torch.addmm(lx_c, P1_t, mc0, alpha=-2))
                rt = torch.matmul(P2_t, d)
                return rt, rt[:n] - av[:, None]

            ms = cuda_ms(torch, lambda: mr.mcep_residual_lane_major(*args),
                         100)
            dev_ms = kernel_device_ms(
                torch, lambda: mr.mcep_residual_lane_major(*args),
                "mcep_residual_kernel")[0]
            plain = cuda_ms(torch, lambda: mr.mcep_residual_plain(*args), 50)
            lib = cuda_ms(torch, addmm, 50)
            flops, nbytes = residual_work(n, B, F)
            bound, by = bound_ms(nbytes, flops)
            times.append(
                f"{cell} (B={B}, F={F}): kernel {ms:.4f} ms a step, device "
                f"{device_rate(nbytes, dev_ms, bound)}; twin {plain:.4f}; "
                f"addmm {lib:.4f}; bound {bound:.5f} ms ({by})")
            if result is None:
                result = dict(max_abs_err=rows[f"{cell} first state"][0],
                              ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=by, library_ms=lib)
                back = (mc0[:, :2000].contiguous(), lx[:2000].contiguous(),
                        P1, P2, av)
        del lx, mc0, mc, args, lx_c
        torch.cuda.empty_cache()
    for M in (0, 1, 11, 32):
        a = pt.MelCepstralAnalysis(fft_length=512, cep_order=M, alpha=0.42,
                                   n_iter=1, device=dev, dtype=torch.float32)
        g = torch.Generator(dev).manual_seed(M)
        lx = torch.log(torch.rand((3001, 257), generator=g, device=dev)
                       + 0.05)
        hold(f"n={M + 1} (B=3001, F=257)",
             (torch.matmul(lx, a.P0).T.contiguous(), lx, a.P1, a.P2,
              a.alpha_vector))
    # The backward, every input learnable, against autograd through the
    # twin, at 2,000 frames of the first shape.
    g = torch.Generator(dev).manual_seed(3)
    w = (torch.randn(49, 2000, device=dev, generator=g),
         torch.randn(25, 2000, device=dev, generator=g))

    def grads(f):
        xs = [a.detach().clone().requires_grad_(True) for a in back]
        rt, ra = f(*xs)
        ((w[0] * rt).sum() + (w[1] * ra).sum()).backward()
        return [a.grad for a in xs]

    err_grad = max(
        float((a - b).abs().max()) / float(b.abs().max())
        for a, b in zip(grads(mr.mcep_residual),
                        grads(mr.mcep_residual_plain)))
    check(err_grad <= 1e-4, f"K9 backward disagrees with the twin's: "
          f"{err_grad:.3e} of each gradient's max")
    print("[K9] |out-f64| / max|rt| kernel, twin (ra's over max|ra| kernel, "
          "twin): " + "; ".join(
              f"{k} {v[0]:.3e}, {v[1]:.3e} ({v[2]:.3e}, {v[3]:.3e})"
              for k, v in rows.items())
          + f" (bar {RESIDUAL_BAR} for the kernel); backward {err_grad:.3e} "
          f"(tol 1e-4); " + "; ".join(times) + f"; ptxas "
          f"mcep_residual_kernel: {ptxas} | {card}", flush=True)
    return result


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


MGC = dict(alpha=0.42, c=3)     # [mgc]: HTS's gamma = -1/3 at 16 kHz


def mgc_chain(torch, device, dtype):
    """[mgc]'s chain: STFT(400, 80, 512) power spectrum ->
    MelGeneralizedCepstralAnalysis(M=24, alpha 0.42, c=3) -> the inverse
    MGLSA filter to the excitation -> the MGLSA filter (cep_order 199,
    Taylor order 20, the fused cascade).  Returns x -> (mgc, excitation,
    resynthesis) and the analysis stage alone.

    The inverse of the MGLSA filter (1 + gamma C(z))^(1/gamma) is the
    MGLSA filter at -gamma on -mgc, (1 - gamma C(z))^(-1/gamma).
    PseudoInverseMGLSADigitalFilter negates mgc at the same gamma, which
    inverts the filter only at gamma = 0."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    P = 80
    stft = pt.STFT(400, P, 512, eps=0, relative_floor=-80,
                   out_format="power", **kw)
    mgcep = pt.MelGeneralizedCepstralAnalysis(
        fft_length=512, cep_order=24, n_iter=10, **MGC, **kw)
    fkw = dict(alpha=MGC["alpha"], cep_order=199, taylor_order=20,
               cascade="fused", **kw)
    gamma = -1.0 / MGC["c"]
    inverse = pt.PseudoMGLSADigitalFilter(24, P, gamma=-gamma, **fkw)
    mglsa = pt.PseudoMGLSADigitalFilter(24, P, gamma=gamma, **fkw)

    def analysis(xw):
        return mgcep(stft(xw))

    def roundtrip(xw):
        mgc = analysis(xw)
        e = inverse(xw[..., :mgc.shape[-2] * P], -mgc)
        return mgc, e, mglsa(e, mgc)

    return roundtrip, analysis


def toephank_case(n: int, B: int, seed: int = 11):
    """Two-generator Newton systems: p (n, B), q (2n-1, B), b (n, B),
    float32, lane-major, diagonally dominant."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, B)).astype(np.float32) * 0.1
    p[0] += 4.0 + n * 0.2
    q = rng.standard_normal((2 * n - 1, B)).astype(np.float32) * 0.1
    b = rng.standard_normal((n, B)).astype(np.float32)
    return p, q, b


def check_toephank(torch, dev, card: str, ptxas: str) -> dict:
    """[K1]'s two-generator rows: the entry mgcep takes, at n=24 and
    B=7,680 (mgcep's systems at the flagship's frame count) against its
    twin and a float64 solve, its backward against the twin's, n = 1, 12
    and 33 against the twin, and its times beside the bound and
    torch.linalg.solve on the dense matrix."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import newton

    tol = 2e-4
    errs = {}
    for n in (1, 12, 33):
        p, q, b = (torch.as_tensor(a, device=dev)
                   for a in toephank_case(n, 1001, seed=n))
        x_k = newton.toephank_solve_lane_major(p, q, b)
        x_p = newton.toephank_solve_plain(p, q, b)
        errs[n] = float((x_k - x_p).abs().max())
        check(bool(torch.allclose(x_k, x_p, rtol=tol, atol=tol)),
              f"K1 two generators n={n} disagrees with its twin: {errs[n]}")
    n, B = 24, 7680
    p, q, b = (torch.as_tensor(a, device=dev) for a in toephank_case(n, B))
    x_k = newton.toephank_solve_lane_major(p, q, b)
    x_p = newton.toephank_solve_plain(p, q, b)
    i = np.arange(n)
    idx_t = torch.as_tensor(np.abs(i[:, None] - i[None, :]), device=dev)
    idx_h = torch.as_tensor(i[:, None] + i[None, :], device=dev)
    A64 = p.double().T[:, idx_t] + q.double().T[:, idx_h]    # (B, n, n)
    x_64 = torch.linalg.solve(A64, b.double().T[..., None])[..., 0].T
    err_twin = float((x_k - x_p).abs().max())
    err_64 = float((x_k.double() - x_64).abs().max())
    check(bool(torch.allclose(x_k, x_p, rtol=tol, atol=tol)),
          f"K1 two generators disagrees with its twin: {err_twin}")
    check(bool(torch.allclose(x_k.double(), x_64, rtol=tol, atol=tol)),
          f"K1 two generators disagrees with the float64 solve: {err_64}")
    leaves = [t.clone().requires_grad_(True) for t in (p, q, b)]
    g = torch.cos(x_p)
    newton.toephank_solve_t(*leaves).backward(g)
    grads = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    with twins():
        newton.toephank_solve_t(*leaves).backward(g)
    err_grad = max(float((a - t.grad).abs().max())
                   for a, t in zip(grads, leaves))
    check(all(bool(torch.allclose(a, t.grad, rtol=tol, atol=tol))
              for a, t in zip(grads, leaves)),
          f"K1 two generators' backward disagrees with the twin's: "
          f"{err_grad}")

    def solve():
        return newton.toephank_solve_lane_major(p, q, b)

    ms = cuda_ms(torch, solve, 200)
    dev_ms = kernel_device_ms(torch, solve, "newton_kernel")[0]
    plain_ms = cuda_ms(torch, lambda: newton.toephank_solve_plain(p, q, b),
                       3, warm=1)
    A32, b32 = A64.float(), b.T.contiguous()[..., None]
    lib_ms = cuda_ms(torch, lambda: torch.linalg.solve(A32, b32), 20)
    nbytes = (n + 2 * n - 1 + 2 * n) * B * 4.0
    bound, by = bound_ms(nbytes, B * (n ** 3 / 3 + 2 * n ** 2))
    print(f"[K1] two generators (mgcep's entry) n={n} B={B}: |kernel-twin| "
          f"{err_twin:.3e}, |kernel-f64| {err_64:.3e}, backward "
          f"{err_grad:.3e}, n = 1, 12, 33 at B=1,001: "
          + ", ".join(f"{v:.3e}" for v in errs.values())
          + f" (tol {tol}); kernel {ms:.4f} ms, twin {plain_ms:.3f} ms, "
          f"torch.linalg.solve {lib_ms:.4f} ms, bound {bound:.5f} ms ({by}), "
          f"{100 * bound / ms:.2f} % of the bound reached; the kernel's "
          f"device time {device_rate(nbytes, dev_ms, bound)}; ptxas "
          f"newton_kernel: {ptxas} | {card}", flush=True)
    return dict(max_abs_err=err_twin, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


def run_mgc(torch, xs, card: str) -> dict:
    """[mgc]: the mel-generalized cepstral chain (mgc_chain: mgcep at
    gamma = -1/3, then the inverse and forward MGLSA filters) on the
    card, float32: launch counts (the Newton kernel's two-generator entry
    1 + n_iter = 11 times, the cascade 2 x 20), mgc and y of the kernel
    path against the twin path (mgc 1e-4, y 1e-2 of max|y|), row 0's y
    against a float64 run on the CPU (1e-2 of max|y|), the SNR of y
    against x above 20 dB, finite non-zero gradients through mgcep (the
    two-generator backward), the median and p90 of 20 calls, the busy
    share, the top device functions and peak memory."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import mlsa, newton, solve

    B, T = xs.shape
    chain, analysis = mgc_chain(torch, "cuda", torch.float32)
    for mod in (newton, mlsa, solve):
        mod.launches = 0
    newton.launches_toephank = 0
    with torch.no_grad():
        mgc, e, y = chain(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches,
                    "newton_toephank": newton.launches_toephank,
                    "mlsa_cascade": mlsa.launches,
                    "spd_solve": solve.launches}
        want = {"newton": 11, "newton_toephank": 11, "mlsa_cascade": 40,
                "spd_solve": 0}
        for key, count in want.items():
            check(launches[key] == count,
                  f"[mgc] {key} launched {launches[key]} times, expected "
                  f"{count}")
        x_n = xs[..., :mgc.shape[-2] * 80]
        check(y.shape == x_n.shape and bool(torch.isfinite(y).all())
              and tuple(mgc.shape) == (B, T // 80, 25),
              "[mgc] output is not finite or has the wrong shape")
        with twins():
            mgc_p, _, y_p = chain(xs)
        torch.cuda.synchronize()
        err_mgc = float((mgc - mgc_p).abs().max())
        check(bool(torch.allclose(mgc, mgc_p, rtol=1e-4, atol=1e-4)),
              f"[mgc] mgc of the kernel path disagrees with the twin path: "
              f"{err_mgc}")
        y_scale = float(y_p.abs().max())
        err_y = float((y - y_p).abs().max())
        check(err_y <= 1e-2 * y_scale,
              f"[mgc] y of the kernel path disagrees with the twin path: "
              f"{err_y} > 1e-2 * {y_scale}")
        chain64, _ = mgc_chain(torch, "cpu", torch.float64)
        mgc64, _, y64 = chain64(xs[:1].double().cpu())
        err_mgc64 = float((mgc[:1].double().cpu() - mgc64).abs().max())
        err_y64 = float((y[:1].double().cpu() - y64).abs().max())
        scale64 = float(y64.abs().max())
        check(err_y64 <= 1e-2 * scale64,
              f"[mgc] row 0's y against float64 on the CPU: {err_y64} > "
              f"1e-2 * {scale64}")
        snr = float(10 * torch.log10((x_n ** 2).sum()
                                     / ((y - x_n) ** 2).sum()))
        check(snr > 20.0, f"[mgc] SNR {snr:.2f} dB is too low")
        calls = cuda_call_ms(torch, lambda: chain(xs), 20)
        ana = float(np.median(cuda_call_ms(torch, lambda: analysis(xs), 20)))
        with twins():
            plain_ms = cuda_ms(torch, lambda: chain(xs), 2, warm=1)
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: chain(xs))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chain(xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    xg = xs[:2, :3200].clone().requires_grad_(True)
    newton.launches_toephank = 0
    (chain(xg)[2] ** 2).sum().backward()
    torch.cuda.synchronize()
    gmax = float(xg.grad.abs().max())
    check(newton.launches_toephank == 22,
          f"[mgc] two-generator launches with the backward "
          f"{newton.launches_toephank}, expected 22")
    check(bool(torch.isfinite(xg.grad).all()) and gmax > 0,
          "[mgc] gradient is not finite or is zero")
    med = float(np.median(calls))
    print(f"[mgc] B={B} T={T} (mgcep M=24, alpha 0.42, c=3, 10 "
          f"iterations; inverse and forward MGLSA, cep_order 199, Taylor "
          f"order 20, fused): launches {launches}; |mgc kernel-twin| "
          f"{err_mgc:.3e} (tol 1e-4); |y kernel-twin| {err_y:.3e} (tol "
          f"1e-2 * {y_scale:.3f}); row 0 against CPU float64: mgc "
          f"{err_mgc64:.3e}, y {err_y64:.3e} (tol 1e-2 * {scale64:.3f}); SNR "
          f"{snr:.2f} dB (bar 20); median {med:.3f} ms per call (p90 "
          f"{float(np.percentile(calls, 90)):.3f}, {len(calls)} calls), "
          f"{B * T / (med * 1e-3):.1f} samples/s, the analysis alone "
          f"{ana:.3f} ms; twin path {plain_ms:.3f} ms; "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; peak memory {peak / 2 ** 30:.3f} GiB "
          f"({(peak - base) / 2 ** 30:.3f} above the "
          f"{base / 2 ** 30:.3f} held before); gradient through mgcep "
          f"(B=2, T=3,200): two-generator launches "
          f"{newton.launches_toephank} with the backward, finite, "
          f"max|dL/dx| {gmax:.4e}; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + f" | {card}",
          flush=True)
    return launches


def analysis_rest_ops(torch, device, dtype) -> dict:
    """[analysis-rest]'s modules, each at the flagship's shapes (fft
    length 512, order 24)."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    return {
        "smcep": pt.SecondOrderAllPassMelCepstralAnalysis(
            fft_length=512, cep_order=24, alpha=0.1, theta=0.3, n_iter=10,
            **kw),
        "lpc2par": pt.LinearPredictiveCoefficientsToParcorCoefficients(
            24, **kw),
        "par2lpc": pt.ParcorCoefficientsToLinearPredictiveCoefficients(
            24, **kw),
        "lpc2lsp": pt.LinearPredictiveCoefficientsToLineSpectralPairs(
            24, **kw),
        "lsp2lpc": pt.LineSpectralPairsToLinearPredictiveCoefficients(
            24, **kw),
        "lsp2sp": pt.LineSpectralPairsToSpectrum(24, 512, **kw),
        "fftcep": pt.CepstralAnalysis(512, 24, n_iter=3, **kw),
        "c2acr": pt.CepstrumToAutocorrelation(24, 24, n_fft=512, **kw),
        "c2mpir": pt.CepstrumToMinimumPhaseImpulseResponse(24, 128,
                                                           n_fft=512, **kw),
        "mpir2c": pt.MinimumPhaseImpulseResponseToCepstrum(128, 24,
                                                           n_fft=512, **kw),
        "mcpf": pt.MelCepstrumPostfiltering(24, alpha=0.42, beta=0.2, **kw),
        "mlsacheck": pt.MLSADigitalFilterStabilityCheck(
            24, alpha=0.42, fast=False, n_fft=512, **kw),
        "roots-aberth": pt.PolynomialToRoots(24, **kw),
        "roots-eig": pt.PolynomialToRoots(24, method="eig", **kw),
        "acr2csm": pt.AutocorrelationToCompositeSinusoidalModelCoefficients(
            CSM_ORDER, **kw),
        "csm2acr": pt.CompositeSinusoidalModelCoefficientsToAutocorrelation(
            CSM_ORDER, **kw),
    }


# [analysis-rest]'s bars: max |card float32 - CPU float64| over max|CPU
# float64|, on the same inputs.  Ten times a float32 CPU run's reading
# (float32 against float64, both on the CPU, every frame of the same
# signal), rounded up to a power of ten.  lsp2lpc expands a degree-24
# polynomial from its unit-circle roots and keeps about two digits in
# float32 (9.0e-3 on the CPU).
ANALYSIS_REST_BARS = {
    "smcep": 1e-6, "lpc2par": 1e-4, "par2lpc": 1e-5, "lpc2lsp": 1e-6,
    "lsp2lpc": 1e-1, "lsp2sp": 1e-3, "fftcep": 1e-5, "c2acr": 1e-5,
    "c2mpir": 1e-5, "mpir2c": 1e-5, "mcpf": 1e-5, "mlsacheck": 1e-5,
    "roots-aberth": 1e-4, "roots-eig": 1e-2, "acr2csm": 1e-1,
    "csm2acr": 1e-5}
# The composite sinusoidal model's order.  Its frequencies are the
# arccos of a polynomial's roots and its intensities a Vandermonde
# solve, both ill-conditioned in float32: against float64 on the same
# float32 inputs 1.2e-3 of max at order 5, 2.3e-3 at 7, 2.9e-2 at 9, and
# NaN on 440 of 482 frames at 15 (CPU run).
CSM_ORDER = 7


def analysis_rest_inputs(torch, ops, xs) -> dict:
    """Each module's input, made on ``xs``'s device from the port's own
    outputs: the power spectrum, LPC(24) and autocorrelation of the
    400-sample frames, the mel-cepstrum, and the modules' outputs."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=xs.device, dtype=xs.dtype)
    frames = pt.Window(400, **kw)(pt.Frame(400, 80, **kw)(xs))
    sp = pt.STFT(400, 80, 512, eps=0, relative_floor=-80,
                 out_format="power", **kw)(xs)
    a = pt.LPC(400, 24, **kw)(frames)
    mc = pt.MelCepstralAnalysis(fft_length=512, cep_order=24, alpha=0.42,
                                n_iter=10, **kw)(sp)
    c = ops["fftcep"](sp)
    w = ops["lpc2lsp"](a)
    r = pt.Autocorrelation(400, CSM_ORDER, **kw)(frames)
    poly = torch.cat((torch.ones_like(a[..., :1]), a[..., 1:]), dim=-1)
    return {"smcep": sp, "lpc2par": a, "par2lpc": ops["lpc2par"](a),
            "lpc2lsp": a, "lsp2lpc": w, "lsp2sp": w, "fftcep": sp,
            "c2acr": c, "c2mpir": c, "mpir2c": ops["c2mpir"](c),
            "mcpf": mc, "mlsacheck": mc, "roots-aberth": poly,
            "roots-eig": poly, "acr2csm": r,
            "csm2acr": ops["acr2csm"](r)}


def analysis_rest_errors(out: dict, ref: dict) -> dict:
    """For each module, max |out - ref| over max |ref| of each frame
    (roots as sets, each of ``ref``'s against the nearest of
    ``out``'s), flattened over the frames."""
    errs = {}
    for name, want in ref.items():
        got = out[name].cpu().to(want.dtype)
        if name.startswith("roots"):
            diff = (got[..., :, None] - want[..., None, :]).abs().amin(-2)
        else:
            diff = (got - want).abs()
        errs[name] = (diff.amax(-1) / want.abs().max()).flatten()
    return errs


# Frames a module may miss its bar on, as a share of the frames.  The
# float32 Aberth iteration gives NaN on 1 of the 7,680 polynomials of
# [mgc]'s signal in both packages, the same one (two iterates meet at a
# root: 0 times inf; CPU runs).
FRAMES_OFF = {"roots-aberth": 1e-3}


# The modules of [analysis-rest] that read the card back to the host by
# design: PolynomialToRoots(method="eig") takes the companion eigenvalues
# on the host, as the JAX package's callback does (ops/rootpol.py:
# eig_roots), one copy of the batch there, one batched LAPACK call and
# one copy back.  (torch.linalg.eigvals of the CUDA tensor, MAGMA's geev
# one matrix at a time with a hidden round trip each, took 14.5 to 15.3 s
# for these 7,680 companion matrices of order 24 on an H100 80GB HBM3 at
# 700 W.)  They run once, outside the sync check, timed by the host
# clock.
HOST_READS = ("roots-eig",)


def run_analysis_rest(torch, xs, card: str) -> None:
    """[analysis-rest]: every module this slice adds beside mgcep, once
    on the card at the flagship's shapes (32 x 19,200 samples: 240
    frames a row) on the port's own outputs, float32, each against the
    port's float64 run on the CPU of the same inputs, every frame, within
    its bar (ANALYSIS_REST_BARS; all but FRAMES_OFF of the frames for
    the float32 Aberth iteration); smcep takes the Newton kernel's
    one-generator entry 10 times; no module but HOST_READS reads the card
    back to the host (torch.cuda.set_sync_debug_mode("error") around each
    call, after a first call that makes the libraries' plans); each
    module's median time of 5 calls."""
    from diffsptk_tpu_torch.kernels import mcep_residual, newton

    ops = analysis_rest_ops(torch, "cuda", torch.float32)
    ops64 = analysis_rest_ops(torch, "cpu", torch.float64)
    on_card = [name for name in ops if name not in HOST_READS]
    with torch.no_grad():
        inputs = analysis_rest_inputs(torch, ops, xs)
        for name in on_card:
            ops[name](inputs[name])
        torch.cuda.synchronize()
        newton.launches = newton.launches_toephank = 0
        mcep_residual.launches = 0
        out, synced = {}, []
        for name in on_card:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out[name] = ops[name](inputs[name])
            except RuntimeError as exc:
                if "synchroniz" not in str(exc):
                    raise
                synced.append(name)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if name == "smcep":
                torch.cuda.synchronize()
                launches = (newton.launches, newton.launches_toephank,
                            mcep_residual.launches)
                check(launches == (10, 0, 10),
                      f"[analysis-rest] smcep: Newton launches (all, "
                      f"two-generator) and mcep residual launches "
                      f"{launches}, expected (10, 0, 10)")
        check(not synced, f"[analysis-rest] host reads in {synced}")
        ms = {name: float(np.median(cuda_call_ms(
            torch, lambda op=ops[name], x=inputs[name]: op(x), 5, warm=1)))
            for name in on_card}
        for name in HOST_READS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = ops[name](inputs[name])
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        ref = {name: op(inputs[name].double().cpu())
               for name, op in ops64.items()}
        frame_errs = analysis_rest_errors(out, ref)
        n_frames = frame_errs["smcep"].numel()
        off, errs = {}, {}
        for name, e in frame_errs.items():
            within = e <= ANALYSIS_REST_BARS[name]      # NaN is not
            off[name] = int((~within).sum())
            errs[name] = float(e[within].max()) if within.any() else 1.0
            check(off[name] <= FRAMES_OFF.get(name, 0.0) * n_frames,
                  f"[analysis-rest] {name} against float64 on the CPU: "
                  f"{off[name]} of {n_frames} frames beyond the bar "
                  f"{ANALYSIS_REST_BARS[name]} (max "
                  f"{float(e.nan_to_num(nan=float('inf')).max()):.3e})")
        nonfinite = {name: int((~torch.isfinite(v)).sum())
                     for name, v in out.items()}
        check(not any(n for name, n in nonfinite.items()
                      if name not in FRAMES_OFF),
              f"[analysis-rest] outputs not finite: {nonfinite}")
    print(f"[analysis-rest] B={xs.shape[0]} T={xs.shape[1]} (240 frames a "
          f"row, order 24, fft length 512), float32 against float64 on "
          f"the CPU, every frame, of max|.|: "
          + ", ".join(f"{k} {v:.3e} (bar {ANALYSIS_REST_BARS[k]})"
                      for k, v in errs.items())
          + f"; frames beyond the bar (each max above is over the "
          f"others): " + ", ".join(
              f"{k} {off[k]} of {n_frames} (allowed "
              f"{FRAMES_OFF[k] * n_frames:.0f})" for k in FRAMES_OFF)
          + f"; smcep's Newton launches 10 (one generator); no host read "
          f"but in {list(HOST_READS)} (not checked); median ms per call (5 "
          f"calls; {list(HOST_READS)} one call, host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" | {card}", flush=True)


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
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: chain(xs))
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
          + f"; {busy_share(busy_ms, wall_ms)} in {n_device:.0f} "
          f"device functions per call; top device time: "
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


def ptxas_smem_spills(log: str, kernel: str) -> str:
    """The range of static shared memory over the instances of ``kernel``
    in a build log (-Xptxas -v), and the template arguments of those that
    spill."""
    smem, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            arg = re.search(r"ILi(\d+)E", ln)
            key = (int(arg.group(1)) if arg else ln) if kernel in ln \
                else None
        elif key is not None and "Used" in ln:
            found = re.search(r"(\d+) bytes smem", ln)
            smem[key] = int(found.group(1)) if found else 0
    if not smem:
        return "shared memory not in the build log"
    spills = sorted(k for k, (_, sp) in ptxas_usage(log, kernel).items()
                    if sp)
    return (f"{min(smem.values())}-{max(smem.values())} bytes of shared "
            f"memory; " + (f"spills at {spills}" if spills
                           else "no instance spills"))


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
    Bits and normals equal bit for bit (the kernel and the twin both copy
    XLA CPU's log1p and its fused multiply-adds).  Times of all the draws
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
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K8 {kind} {tuple(shape)}: normals differ from the twin's "
              f"(at most {site_rel} relative)")
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
          + ", ".join(shapes) + f"): bits and normals equal to the twin's "
          f"bit for bit ({rel:.3e} relative, max abs {err:.3e}); all "
          f"draws: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, library "
          f"none (torch.randn draws other numbers), {nbytes / 1e6:.2f} MB "
          f"out, {ops / 1e9:.3f} G operations, bound {bound:.5f} ms ({by}); "
          f"the kernel's device time {device_rate(nbytes, dev_ms, bound)} "
          f"| {card}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


class NoiseTape:
    """Records the random draws of a WORLD call (the windowed waveform's
    dither and the synthesis's slot noise) and replays the first ``rows``
    (row 0 by default) of each, as float64 on the CPU, in the same order:
    a float64 CPU run of those rows then sees the recorded noise."""

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

    def replay(self, synth64, rows: int = 1):
        dither = self.wc.dither_noise
        tape = iter(self.tape)

        def play(*args, **kwargs):
            return next(tape)[:rows].to(device="cpu",
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
              full: bool, pitch_algorithm: str = "yin",
              f0_cents: float | None = None) -> tuple:
    """[world] / [world-tandem] / [world-fcnf0]: WorldVocoder on the card,
    float32.  Returns the launch counts, the recorded gather, overlap-add
    and noise-draw call sites of one call, and its f0.

    With YIN, row 0's float64 CPU run analyses on its own f0, held within
    1e-4 relative.  FCNF0 runs in TF32 on the card: its f0 is
    held against the CPU's (float32 network, full fp32) within
    ``f0_cents`` cents, and the rest of the float64 chain analyses on the
    card's f0, so D4C, CheapTrick and the synthesis meet [world]'s bars
    on the same f0 and the same noise."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import gather, ola, threefry
    from diffsptk_tpu_torch.ops import world_common as wc

    B, T = xs.shape
    voc = pt.WorldVocoder(pitch_algorithm=pitch_algorithm,
                          ap_algorithm=ap_algorithm, device="cuda",
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
            voc64 = pt.WorldVocoder(pitch_algorithm=pitch_algorithm,
                                    ap_algorithm=ap_algorithm, device="cpu",
                                    dtype=torch.float64)
            x0 = xs[:1].double().cpu()
            f0_0 = f0[:1].double().cpu()
            # the card's noise: JAX's float64 stream draws other numbers
            # than its float32 one (other bits make each uniform)
            undo = tape.replay(voc64.synth)
            if pitch_algorithm == "yin":
                f0_64, ap_64, sp_64 = voc64.analyze(x0)
                f0_syn = f0_64
            else:
                f0_64 = voc64.pitch(x0)
                ap_64, sp_64 = voc64.ap(x0, f0_0), voc64.spec(x0, f0_0)
                f0_syn = f0_0
            y64 = voc64.synthesize(f0_syn, ap_64, sp_64, out_length=T)
            undo()
            both = (f0_0 > 0) & (f0_64 > 0)
            same_vuv = float(((f0_0 > 0) == (f0_64 > 0)).double().mean())
            err_f0 = float(((f0_0 - f0_64).abs() / f0_64.clamp(min=1))[both]
                           .max())
            if f0_cents is None:
                f0_ok, f0_bar = err_f0 <= 1e-4, "tol 1e-4 relative"
            else:
                cents = float(cents_diff(f0_0, f0_64)[both].abs().max())
                f0_ok = cents <= f0_cents
                f0_bar = (f"{cents:.3f} cents, tol {f0_cents} cents; ap, sp "
                          f"and y on the card's f0")
            check(same_vuv >= 0.98 and f0_ok,
                  f"{tag}: f0 of row 0 against float64: voicing agrees on "
                  f"{same_vuv:.3f}, relative f0 error {err_f0} ({f0_bar})")
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
                   f"voiced {err_f0:.3e} ({f0_bar}), sp "
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
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: voc.analysis_synthesis(xs))
        noise_ms = kernel_device_ms(
            torch, lambda: voc.analysis_synthesis(xs), "threefry", calls=3)[0]
        prof = (f"; {busy_share(busy_ms, wall_ms)} in {n_device:.0f} "
                f"device functions per call; noise "
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
    return launches, gather_sites, ola_sites, noise, f0


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


def synth_f0(B: int, T: int) -> np.ndarray:
    """The f0 glide (Hz per sample) of each row of ``synth_speech``."""
    rows = []
    for b in range(B):
        rng = np.random.default_rng(1000 + b)
        rows.append(np.linspace(rng.uniform(90, 140), rng.uniform(180, 260),
                                T))
    return np.stack(rows)


def cents_diff(a, b):
    """1200 log2(a / b), elementwise (meaningful where both are voiced)."""
    return 1200 * (a.clamp(min=1e-9) / b.clamp(min=1e-9)).log2()


def conv_flops(algo: str, model: str = "tiny") -> float:
    """Multiply-adds x 2 of one frame through a pitch network's conv stack
    and head (CREPE's classifier), from its layer plan."""
    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    macs = 0
    if algo == "fcnf0":
        L, k = 993, nn_._FCNF0_KERNEL
        for ci, co, _ln, pool in nn_._FCNF0_BLOCKS:
            L = L - k + 1
            macs += co * ci * k * L
            L = L // pool[1] if pool else L
        macs += nn_.PENN_PITCH_BINS * 512 * 4
    else:
        cap = nn_._CREPE_CAPACITY[model]
        L = nn_.CREPE_WINDOW_SIZE
        for ci, co, k, st, pad in zip(cap["in_channels"],
                                      cap["out_channels"],
                                      nn_._CREPE_KERNELS,
                                      nn_._CREPE_STRIDES, nn_._CREPE_PADS):
            L = (L + sum(pad) - k) // st + 1
            macs += co * ci * k * L
            L //= 2
        macs += nn_.CREPE_PITCH_BINS * cap["in_features"]
    return 2.0 * macs


def run_pitch(torch, xs, card: str, algo: str, kw: dict, tag: str) -> dict:
    """[pitch-fcnf0] / [pitch-crepe]: Pitch(out_format="f0") on the card,
    float32, its network at its default precision (the main path) and at
    the other one.  The full fp32 run is held against the port on the CPU
    (rows 0-1); where the default is TF32, the TF32 run is held against
    the full one.  Times, the stage split by CUDA events, the conv
    stack's rate against its peak, and peak memory."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.core import full_precision
    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    B, T = xs.shape

    def make(device):
        return pt.Pitch(80, 16000, algorithm=algo, out_format="f0",
                        device=device, dtype=torch.float32, **kw)

    op = make("cuda")                            # the main path
    ext = op.extractor
    default = ext.PRECISION
    other = "full" if default == "tf32" else "tf32"

    def fwd(f, prec):
        if algo == "fcnf0":
            return nn_.fcnf0_forward(ext.params, f, precision=prec)
        return nn_.crepe_forward(ext.params, f, ext.model, precision=prec)

    @full_precision
    def f0_at(prec):
        """The extractor's f0 with its network at ``prec``, as
        ``Pitch.forward`` runs it."""
        frames = ext.frames(xs)
        out = nn_.run_network(lambda f: fwd(f, prec),
                              frames.reshape(-1, 1024))
        out = out.reshape(*frames.shape[:-1], -1)
        return ext.decode(out) if algo == "fcnf0" else ext.decode(out, xs)

    rows = 2
    with torch.no_grad():
        op(xs)                                   # libraries, plans
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        f0_main = op(xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        f0_same, f0_other = f0_at(default), f0_at(other)
        same = (bool(torch.equal(f0_same > 0, f0_main > 0))
                and float((f0_same - f0_main).abs().max()) <= 1e-6
                * float(f0_main.abs().max()))
        check(same, f"{tag}: the network's forward at {default} does not "
              f"give Pitch's f0")
        f0, f0_full = ((f0_main, f0_other) if default == "tf32"
                       else (f0_other, f0_main))
        f0_cpu = make("cpu")(xs[:rows].cpu())
        N = T // 80 + 1
        check(tuple(f0_main.shape) == (B, N)
              and bool(torch.isfinite(f0_main).all()),
              f"{tag}: f0 is not finite or has the wrong shape")
        a = f0_full[:rows].cpu()
        both = (a > 0) & (f0_cpu > 0)
        vuv_cpu = bool(torch.equal(a > 0, f0_cpu > 0))
        err_cpu = float(((a - f0_cpu).abs() / f0_cpu.clamp(min=1))[both]
                        .max()) if bool(both.any()) else 0.0
        check(vuv_cpu and err_cpu <= 1e-4,
              f"{tag}: full fp32 on the card against the CPU: voicing equal "
              f"{vuv_cpu}, relative f0 error {err_cpu} (tol 1e-4)")
        agree = float(((f0 > 0) == (f0_full > 0)).double().mean())
        both = (f0 > 0) & (f0_full > 0)
        c = cents_diff(f0, f0_full)[both].abs()
        c_max = float(c.max()) if c.numel() else 0.0
        c_med = float(c.median()) if c.numel() else 0.0
        n_far = int((c > TF32_CENTS).sum())
        if default == "tf32":
            check(agree >= 0.99 and c_max <= TF32_CENTS,
                  f"{tag}: TF32 against full fp32: voicing agrees on "
                  f"{agree}, max {c_max} cents (tol {TF32_CENTS})")
            tf32_bar = f"bars 0.99 and {TF32_CENTS} cents"
        else:
            tf32_bar = "for information: the default is full fp32"
        truth = torch.as_tensor(synth_f0(B, T)[:, np.minimum(
            np.arange(N) * 80, T - 1)], device=f0.device).float()

        def err_cents(f):
            e = cents_diff(f, truth)[f > 0].abs()
            return float(e.median()), float(e.quantile(0.9))

        true_tf32, true_full = err_cents(f0), err_cents(f0_full)
        voiced = f0_main > 0

        calls = cuda_call_ms(torch, lambda: op(xs), 20)
        calls_other = cuda_call_ms(torch, lambda: f0_at(other), 10)
        med, p90 = float(np.median(calls)), float(np.percentile(calls, 90))
        med_other = float(np.median(calls_other))
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: op(xs))

        # stage split by CUDA events, each stage on the call's own data
        t_res = cuda_ms(torch, lambda: ext.resample(xs), 10)
        if algo == "fcnf0":
            out = ext._logits(xs)

            def dec():
                return ext.decode(out)
        else:
            out = ext.calc_prob(xs)

            def dec():
                return ext.decode(out, xs)
        frames = ext.frames(xs).reshape(-1, 1024)
        t_net = cuda_ms(torch, lambda: nn_.run_network(
            lambda f: fwd(f, "tf32"), frames), 5)
        t_net_full = cuda_ms(torch, lambda: nn_.run_network(
            lambda f: fwd(f, "full"), frames), 3)
        t_dec = cuda_ms(torch, dec, 5)
        dec_name = "argmax decode"
        if algo == "crepe":
            probs = out * ext.bin_mask
            t_vit = cuda_ms(torch, lambda: nn_.viterbi_decode(
                probs, ext.transition), 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nn_.viterbi_decode(probs, ext.transition)
            vit_host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            vit_dev = kernel_device_ms(torch, lambda: nn_.viterbi_decode(
                probs, ext.transition), "", calls=3)[1]
            dec_name = (f"decode (Viterbi {t_vit:.3f} ms per call, device "
                        f"busy {vit_dev:.3f} ms, host enqueue "
                        f"{vit_host:.3f} ms; weighted cents, filters, "
                        f"loudness)")
    flops = conv_flops(algo, kw.get("model", "tiny")) * frames.shape[0]
    rest = med - t_res - (t_net if default == "tf32" else t_net_full) - t_dec
    net_sr = 8000 if algo == "fcnf0" else 16000
    voiced_share = float(voiced.double().mean())
    print(f"[{tag}] B={B} T={T} ({frames.shape[0]} frames of 1024 at "
          f"{net_sr} Hz): f0 finite, {voiced_share:.4f} voiced; full fp32 "
          f"on the card against the CPU (rows 0-{rows - 1}): voicing equal, "
          f"f0 {err_cpu:.3e} (tol 1e-4 relative); TF32 against full fp32: "
          f"voicing agrees on {agree:.4f} of frames, f0 median {c_med:.4f} "
          f"max {c_max:.4f} cents, {n_far} frames beyond {TF32_CENTS} "
          f"({tf32_bar}); cents error against synth_speech's f0 glide, "
          f"median and p90: TF32 {true_tf32[0]:.2f} and {true_tf32[1]:.2f}, "
          f"full fp32 {true_full[0]:.2f} and {true_full[1]:.2f} (for "
          f"information); the default, {default}: median {med:.3f} ms per "
          f"call (p90 {p90:.3f}, {len(calls)} calls), "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions; the other precision: median "
          f"{med_other:.3f} ms ({len(calls_other)} calls); "
          f"stage split (CUDA events): resample {t_res:.3f} ms, "
          f"conv stack TF32 {t_net:.3f} ms, full fp32 {t_net_full:.3f} ms, "
          f"{dec_name} {t_dec:.3f} ms, rest {rest:.3f} ms; conv stack "
          f"{flops / 1e12:.4f} TFLOP: TF32 {flops / t_net / 1e9:.2f} "
          f"TFLOP/s, {100 * flops / t_net / 1e9 / 495:.2f} % of the 495 "
          f"TFLOP/s TF32 peak; full fp32 {flops / t_net_full / 1e9:.2f} "
          f"TFLOP/s, {100 * flops / t_net_full / 1e9 / 67:.2f} % of the 67 "
          f"TFLOP/s fp32 peak; peak memory of one call {peak / 2**30:.3f} "
          f"GiB above {base / 2**30:.3f} GiB held; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + f" | {card}",
          flush=True)
    return dict(ms=med, other_ms=med_other, net_ms=t_net,
                net_full_ms=t_net_full)


def run_straight(torch, xs, f0, card: str) -> None:
    """[straight]: STRAIGHT's envelope on the card, float32, on the f0 of
    [world-fcnf0], against a float64 CPU run of row 0; the time of its
    band-split filters alone."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.ops import straight

    B, T = xs.shape
    kw = dict(frame_period=80, sample_rate=16000, fft_length=2048,
              algorithm="straight")
    op = pt.PitchAdaptiveSpectralAnalysis(**kw, device="cuda",
                                          dtype=torch.float32)
    with torch.no_grad():
        sp = op(xs, f0)
        sp64 = pt.PitchAdaptiveSpectralAnalysis(
            **kw, device="cpu", dtype=torch.float64)(
                xs[:1].double().cpu(), f0[:1].double().cpu())
        check(tuple(sp.shape) == (B, f0.shape[-1], 1025)
              and bool(torch.isfinite(sp).all()),
              "[straight]: envelope is not finite or has the wrong shape")
        err = float(((sp[:1].double().cpu() - sp64).abs()
                     / sp64.amax(-1, True)).max())
        check(err <= 1e-3, f"[straight]: row 0 is {err} of each frame's "
              f"max from float64 (tol 1e-3)")
        calls = cuda_call_ms(torch, lambda: op(xs, f0), 5, warm=1)
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: op(xs, f0), calls=1)

        def band_split():                # the three highpass cascades
            return [straight._sosfilt(sos, xs) for sos in op.extractor.sos]

        iir_ms = float(np.median(cuda_call_ms(torch, band_split, 5, warm=1)))
        iir_busy, _, iir_n, _, iir_wall = profile_chain(
            torch, band_split, calls=1)
    med = float(np.median(calls))
    print(f"[straight] B={B} T={T} fft 2048: row 0 against CPU float64 "
          f"{err:.3e} of each frame's max (tol 1e-3); median {med:.3f} ms "
          f"per call ({len(calls)} calls), {busy_share(busy_ms, wall_ms)} "
          f"in {n_device:.0f} device functions per call; of which the band "
          f"split (9 biquad sections through the plain blocked recurrence) "
          f"{iir_ms:.3f} ms, {busy_share(iir_busy, iir_wall)} in "
          f"{iir_n:.0f} device functions; top "
          f"device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:4])
          + f" | {card}", flush=True)


def run_excite(torch, f0, card: str) -> None:
    """[excite]: ExcitationGeneration(80), Gaussian unvoiced noise, on the
    card in float32, on the f0 of [world-fcnf0] with frames 100-139 of
    every row set unvoiced so the noise shows: one threefry launch per
    call, and the output equal to the twin path's within the draws' bar
    (rtol 1e-6)."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import threefry

    f0 = f0.clone()
    f0[:, 100:140] = 0
    p = torch.where(f0 > 0, 16000 / f0.clamp(min=1e-3), torch.zeros_like(f0))
    op = pt.ExcitationGeneration(80, device="cuda", dtype=torch.float32)
    with torch.no_grad():
        before = threefry.launches
        e = op(p)
        torch.cuda.synchronize()
        n = threefry.launches - before
        check(n == 1, f"[excite]: threefry launched {n} times, expected 1")
        with twins():
            e_p = op(p)
        check(bool(torch.isfinite(e).all()), "[excite]: not finite")
        torch.testing.assert_close(e, e_p, rtol=1e-6, atol=0)
        noise = e[:, 100 * 80:140 * 80]
        calls = cuda_call_ms(torch, lambda: op(p), 20)
        with twins():
            plain_ms = cuda_ms(torch, lambda: op(p), 5)
    med = float(np.median(calls))
    print(f"[excite] B={p.shape[0]} N={p.shape[1]} (T={e.shape[-1]}): "
          f"threefry launches 1 per call; kernel path against twin path "
          f"within rtol 1e-6 (max {float((e - e_p).abs().max()):.3e}); "
          f"unvoiced noise std {float(noise.std()):.4f}; median {med:.4f} "
          f"ms per call (p90 {float(np.percentile(calls, 90)):.4f}), twin "
          f"path {plain_ms:.4f} ms | {card}", flush=True)


def run_istft(torch, xs, card: str) -> None:
    """[istft]: ISTFT(STFT(x)) at 400/80/512 on the card, float32."""
    import diffsptk_tpu_torch as pt

    B, T = xs.shape
    kw = dict(frame_length=400, frame_period=80, fft_length=512,
              device="cuda", dtype=torch.float32)
    stft = pt.STFT(**kw, out_format="complex")
    istft = pt.ISTFT(**kw)
    with torch.no_grad():
        S = stft(xs)
        y = istft(S, out_length=T)
        err = (y - xs)[..., :-80]                # the tail lacks WOLA cover
        snr = float(10 * torch.log10((xs ** 2).sum() / (err ** 2).sum()))
        check(tuple(y.shape) == (B, T) and snr > 60,
              f"[istft]: round-trip SNR {snr:.2f} dB (bar 60)")
        both = cuda_call_ms(torch, lambda: istft(stft(xs), out_length=T), 20)
        inv = cuda_call_ms(torch, lambda: istft(S, out_length=T), 20)
    print(f"[istft] B={B} T={T} 400/80/512: round-trip SNR {snr:.2f} dB "
          f"(bar 60); STFT + ISTFT median {float(np.median(both)):.4f} ms, "
          f"ISTFT alone {float(np.median(inv)):.4f} ms | {card}", flush=True)


def run_chain48(torch, card: str) -> dict:
    """[chain48]: MelCepstralVocoder at 48 kHz, 5 ms frames, on the card:
    its 200-tap stages fit one frame period, so both cascades take the
    unchunked entry.  Taylor order 25: at alpha 0.55 the default order 20
    does not converge on this speech, in the JAX package as in the port
    (tests/test_torch_mlsa.py::test_mcep_vocoder_48k_taylor_order_matches_jax)."""
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import mcep_residual, mlsa, newton

    B, T, S = 32, 57600, 25
    xs = torch.as_tensor(synth_speech(B, T, sr=48000), device="cuda")
    voc = MelCepstralVocoder(frame_length=1200, frame_period=240,
                             fft_length=2048, cep_order=24, alpha=0.55,
                             taylor_order=S, cascade="fused", device="cuda",
                             dtype=torch.float32)
    with torch.no_grad():
        newton.launches = mlsa.launches = mlsa.launches_unchunked = 0
        mcep_residual.launches = 0
        y = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches,
                    "mcep_residual": mcep_residual.launches,
                    "mlsa_cascade": mlsa.launches,
                    "mlsa_cascade_unchunked": mlsa.launches_unchunked}
        check(launches == {"newton": 10, "mcep_residual": 10,
                           "mlsa_cascade": 0,
                           "mlsa_cascade_unchunked": 2 * S},
              f"[chain48] launches {launches}, expected Newton 10, mcep "
              f"residual 10, unchunked cascade {2 * S}, chunked 0")
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
        busy_ms, top, n_device, gaps, wall_ms = profile_chain(
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
          f"ms; {busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; {gaps}; top device "
          f"time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
          + f" | {card}", flush=True)
    return launches


def snr_db(torch, ref, y) -> float:
    """10 log10(sum ref^2 / sum (y - ref)^2), in float64."""
    ref, y = ref.double(), y.double()
    return float(10 * torch.log10((ref ** 2).sum() / ((y - ref) ** 2).sum()))


def rel_err(torch, got, want) -> float:
    """max|got - want| over max|want|, want computed in float64."""
    got = got.to(device=want.device, dtype=want.dtype)
    return float((got - want).abs().max() / want.abs().max())


class Battery:
    """bench_all.py's filterbank battery (BASELINE.json configs[4]):
    CQT -> ICQT, MDCT -> IMDCT and PQMF -> IPQMF, summed."""

    def __init__(self, device, dtype):
        import diffsptk_tpu_torch as pt

        kw = dict(device=device, dtype=dtype)
        self.cqt = pt.CQT(64, 16000, n_bin=24, **kw)
        self.icqt = pt.ICQT(64, 16000, n_bin=24, **kw)
        self.mdct, self.imdct = pt.MDCT(256, **kw), pt.IMDCT(256, **kw)
        self.pqmf, self.ipqmf = pt.PQMF(4, 47, **kw), pt.IPQMF(4, 47, **kw)

    def parts(self, x):
        T = x.shape[-1]
        c = self.cqt(x)
        m = self.mdct(x)
        s = self.pqmf(x)
        return dict(cqt=c, icqt=self.icqt(c, out_length=T), mdct=m,
                    imdct=self.imdct(m, out_length=T), pqmf=s,
                    ipqmf=self.ipqmf(s)[..., 0, :T])

    def __call__(self, x):
        T = x.shape[-1]
        y1 = self.icqt(self.cqt(x), out_length=T)
        y2 = self.imdct(self.mdct(x), out_length=T)
        y3 = self.ipqmf(self.pqmf(x))[..., 0, :T]
        return y1 + y2 + y3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def battery_stages(torch, bat, x, iters: int = 10) -> dict:
    """Each stage of one battery call on the inputs it sees in the call:
    its CUDA-event ms (mean of ``iters``) and its bound (``bound_ms``: the
    stage's inputs read once and outputs written once, and its
    operations: a real FFT of L points 2.5 L log2 L, a complex
    multiply-add 8, a real one 2).
    The stages: resampling (the CQT's early downsample and halving, the
    ICQT's upsampling), the CQT's STFTs and FFT-basis matmuls, the ICQT's
    time bases overlap-added (one transposed convolution an octave, the
    basis matmul and the unframe in one), the MDCT and IMDCT, and the
    PQMF and IPQMF convolutions.  Returns {stage: (ms, bound_ms, by)}."""
    from diffsptk_tpu_torch.ops.cqt import basis_overlap_add

    cqt, icqt = bat.cqt, bat.icqt
    C, T = x.shape
    keys = ("resample", "stft", "basis matmuls", "time-basis overlap-add",
            "mdct+imdct", "pqmf convs")
    ms = dict.fromkeys(keys, 0.0)
    work = {k: [0, 0.0] for k in keys}

    def stage(key, fn, ins, flops):
        out = fn()
        ms[key] += cuda_ms(torch, fn, iters, warm=1)
        work[key][0] += nbytes(*ins, out)
        work[key][1] += flops(out)
        return out

    def resample(rs, xin, scale=1.0):
        return stage("resample", lambda: rs(xin) * scale, [xin, rs.kernel],
                     lambda out: 2 * out.numel() * rs.kernel.numel()
                     / rs.new_freq)

    xo = resample(cqt.early_downsample, x, cqt.downsample_scale)
    for i, stft in enumerate(cqt.transforms):
        L = stft.frame.frame_length
        X = stage("stft", lambda: stft(xo), [xo],
                  lambda out: 2.5 * out.shape[-2] * C * L * np.log2(L))
        W = getattr(cqt, f"fft_basis_{i}")
        stage("basis matmuls", lambda: torch.matmul(X, W), [X, W],
              lambda out: 8 * out.numel() * W.shape[0])
        if i < len(cqt.halves):
            xo = resample(cqt.halves[i], xo, cqt.halve_scales[i])
    c = cqt(x)
    for i, sl in enumerate(icqt.slices):
        A = torch.cat([c[..., sl].real, c[..., sl].imag], dim=-1)
        tb = getattr(icqt, f"time_basis_{i}")
        v = stage("time-basis overlap-add",
                  lambda: basis_overlap_add(A, tb, icqt.hops[i]), [A, tb],
                  lambda out: 2 * A.numel() * tb.shape[-1])
        rs = icqt.resamplers[i]
        if rs.orig_freq != rs.new_freq:
            resample(rs, v)
    n_frames = bat.mdct(x).shape[-2]
    stage("mdct+imdct", lambda: bat.imdct(bat.mdct(x), out_length=T), [x],
          lambda out: 4 * C * n_frames * 256 * 128)
    s = stage("pqmf convs", lambda: bat.pqmf(x), [x, bat.pqmf.filters],
              lambda out: 2 * out.numel() * bat.pqmf.filters.shape[-1])
    stage("pqmf convs", lambda: bat.ipqmf(s), [s, bat.ipqmf.filters],
          lambda out: 2 * out.numel() * bat.ipqmf.filters[0].numel())
    return {k: (ms[k], *bound_ms(*work[k])) for k in keys}


def run_battery(torch, xs, card: str) -> None:
    """[battery]: bench_all.py's battery (BASELINE.json configs[4]) on 8
    channels x 76,800 samples at 16 kHz, float32 on the card: row 0 of
    each transform against the port's float64 run on the CPU (CQT and
    ICQT within 1e-3 of max|.|, MDCT, IMDCT, PQMF and IPQMF within 1e-4),
    the IMDCT(MDCT(x)) round trip above 90 dB and the IPQMF(PQMF(x)) one
    above 30 dB on the interior; the median and p90 of 50 calls, the busy
    share, a stage split and peak memory."""
    from diffsptk_tpu_torch.kernels import (gather, mlsa, newton, ola,
                                            scan, solve, threefry)

    counters = (newton, mlsa, solve, scan, gather, ola, threefry)
    C, T = xs.shape
    bat = Battery("cuda", torch.float32)
    bat64 = Battery("cpu", torch.float64)
    with torch.no_grad():
        for mod in counters:
            mod.launches = 0
        y = bat(xs)
        torch.cuda.synchronize()
        n_kernel = sum(mod.launches for mod in counters)
        check(tuple(y.shape) == (C, T) and bool(torch.isfinite(y).all()),
              "[battery] output is not finite or has the wrong shape")
        parts = bat.parts(xs)
        x64 = xs[:1].double().cpu()
        parts64 = bat64.parts(x64)
        errs = {k: rel_err(torch, parts[k][:1], parts64[k])
                for k in parts}
        errs["battery"] = rel_err(torch, y[:1], bat64(x64))
        bars = dict(cqt=1e-3, icqt=1e-3, battery=1e-3, mdct=1e-4,
                    imdct=1e-4, pqmf=1e-4, ipqmf=1e-4)
        for k, bar in bars.items():
            check(errs[k] <= bar, f"[battery] {k} row 0 against float64 "
                  f"on the CPU: {errs[k]:.3e} of max (bar {bar})")
        snr_mdct = snr_db(torch, xs, parts["imdct"])
        snr_pqmf = snr_db(torch, xs[:, 50:-50], parts["ipqmf"][:, 50:-50])
        check(snr_mdct > 90.0 and snr_pqmf > 30.0,
              f"[battery] round trips: IMDCT(MDCT(x)) {snr_mdct:.2f} dB "
              f"(bar 90), IPQMF(PQMF(x)) {snr_pqmf:.2f} dB (bar 30)")
        del parts
        calls = cuda_call_ms(torch, lambda: bat(xs), 50)
        stages = battery_stages(torch, bat, xs)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bat(xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: bat(xs))
    med = float(np.median(calls))
    print(f"[battery] C={C} T={T} (16 kHz; CQT(64, 16000, n_bin=24) -> ICQT, "
          f"MDCT(256) -> IMDCT, PQMF(4, 47) -> IPQMF, summed): hand-kernel "
          f"launches {n_kernel} (none on this path); row 0 against float64 "
          f"on the CPU, of max|.|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bars CQT, ICQT, battery 1e-3, the others 1e-4); "
          f"IMDCT(MDCT(x)) {snr_mdct:.2f} dB (bar 90), IPQMF(PQMF(x)) "
          f"{snr_pqmf:.2f} dB on the interior (bar 30); median {med:.3f} "
          f"ms per call (p90 {float(np.percentile(calls, 90)):.3f}, "
          f"{len(calls)} calls), {C * T / (med * 1e-3):.1f} samples/s; "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; stages (ms each alone, and its bound): "
          + ", ".join(f"{k} {v[0]:.3f} (bound {v[1]:.4f}, {v[2]})"
                      for k, v in stages.items())
          + f", sum {sum(v[0] for v in stages.values()):.3f}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above "
          f"the {base / 2 ** 30:.3f} held before the call); top device "
          f"time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
          + f" | {card}", flush=True)


def run_battery_long(torch, xs, card: str, T: int) -> None:
    """[battery-long]: the battery on 8 channels x T samples, [battery]'s
    signal tiled along time (as bench_all.py tiles its speech): every
    output finite, and the round trips held to [battery]'s bars over the
    whole length; the median of 5 calls, peak memory and busy share."""
    C, T0 = xs.shape
    x = xs.repeat(1, -(-T // T0))[:, :T].contiguous()
    bat = Battery("cuda", torch.float32)
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = bat(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(tuple(y.shape) == (C, T) and bool(torch.isfinite(y).all()),
              "[battery-long] output is not finite or has the wrong shape")
        del y
        c = bat.cqt(x)
        check(bool(torch.isfinite(c).all()), "[battery-long] CQT not finite")
        y1 = bat.icqt(c, out_length=T)
        del c
        check(bool(torch.isfinite(y1).all()),
              "[battery-long] ICQT not finite")
        del y1
        m = bat.mdct(x)
        check(bool(torch.isfinite(m).all()), "[battery-long] MDCT not finite")
        y2 = bat.imdct(m, out_length=T)
        del m
        snr_mdct = snr_db(torch, x, y2)
        del y2
        s = bat.pqmf(x)
        check(bool(torch.isfinite(s).all()), "[battery-long] PQMF not finite")
        y3 = bat.ipqmf(s)[..., 0, :T]
        del s
        snr_pqmf = snr_db(torch, x[:, 50:-50], y3[:, 50:-50])
        del y3
        check(snr_mdct > 90.0 and snr_pqmf > 30.0,
              f"[battery-long] round trips: IMDCT(MDCT(x)) {snr_mdct:.2f} dB "
              f"(bar 90), IPQMF(PQMF(x)) {snr_pqmf:.2f} dB (bar 30)")
        calls = cuda_call_ms(torch, lambda: bat(x), 5, warm=1)
        busy_ms, _, n_device, _, wall_ms = profile_chain(
            torch, lambda: bat(x), calls=1)
        stages = battery_stages(torch, bat, x, iters=2)
    med = float(np.median(calls))
    print(f"[battery-long] C={C} T={T} ({T / 16000 / 60:.1f} min at 16 kHz "
          f"a channel, {C * T * 4 / 1e9:.3f} GB of float32 input; "
          f"[battery]'s signal tiled): every output finite; IMDCT(MDCT(x)) "
          f"{snr_mdct:.2f} dB (bar 90), IPQMF(PQMF(x)) {snr_pqmf:.2f} dB on "
          f"the interior (bar 30); median {med:.3f} ms per call "
          f"({len(calls)} calls: " + ", ".join(f"{v:.3f}" for v in calls)
          + f"), {C * T / (med * 1e-3):.1f} samples/s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above "
          f"the {base / 2 ** 30:.3f} held before the call); "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; stages (ms each alone, and its bound): "
          + ", ".join(f"{k} {v[0]:.3f} (bound {v[1]:.4f}, {v[2]})"
                      for k, v in stages.items())
          + f" | {card}", flush=True)


def run_mglsadf_mode(torch, xs, card: str, mode: str, **kw) -> None:
    """[mglsadf-modes]: MelCepstralVocoder(mode=...).analysis_synthesis on
    the flagship's 32 x 19,200 samples, float32 on the card: the Newton
    kernel 10 times a call, row 0 of that call, all 19,200 samples, within
    1e-2 of max|y| of the port's float64 run on the CPU; the median of 20
    calls, busy share, peak memory and the SNR against x."""
    from diffsptk_tpu_torch import MelCepstralVocoder
    from diffsptk_tpu_torch.kernels import mlsa, newton, scan

    B, T = xs.shape
    label = mode + "".join(f", {k}={v!r}" for k, v in kw.items())
    voc = MelCepstralVocoder(mode=mode, **kw, device="cuda",
                             dtype=torch.float32)
    with torch.no_grad():
        newton.launches = mlsa.launches = scan.launches = 0
        y = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches, "mlsa_cascade": mlsa.launches,
                    "scan": scan.launches}
        check(launches == {"newton": 10, "mlsa_cascade": 0, "scan": 0},
              f"[mglsadf-modes] {label}: launches {launches}, expected "
              f"Newton 10 and no other")
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all()),
              f"[mglsadf-modes] {label}: not finite or the wrong shape")
        y64 = MelCepstralVocoder(mode=mode, **kw, device="cpu",
                                 dtype=torch.float64).analysis_synthesis(
            xs[:1].double().cpu())
        err = rel_err(torch, y[:1], y64)
        check(err <= 1e-2, f"[mglsadf-modes] {label}: row 0 against float64 "
              f"on the CPU {err:.3e} of max|y| (bar 1e-2)")
        snr = snr_db(torch, xs, y)
        calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs), 20)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: voc.analysis_synthesis(xs))
    med = float(np.median(calls))
    print(f"[mglsadf-modes] {label}: B={B} T={T}: launches {launches}; row 0 "
          f"of that call, all {T} samples, against float64 on the CPU "
          f"{err:.3e} of max|y| (bar 1e-2); SNR "
          f"against x {snr:.2f} dB; median {med:.3f} ms per call (p90 "
          f"{float(np.percentile(calls, 90)):.3f}, {len(calls)} calls), "
          f"{B * T / (med * 1e-3):.1f} samples/s; "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; peak memory {peak / 2 ** 30:.3f} GiB "
          f"({(peak - base) / 2 ** 30:.3f} above the call's start); top "
          f"device time: " + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:4])
          + f" | {card}", flush=True)


def run_pade(torch, xs, card: str) -> None:
    """[pade]: MelCepstralVocoder(mode="pade-approx") on 32 x 3,200
    samples, float32 on the card (the length cut for the order-199
    sections' per-sample loop): the scan kernel 10 times a call, each on
    complex64, Newton 10; each of those ten scans, every row, against the
    plain twin on its own inputs at [K5]'s complex64 tolerance; the whole
    output against the call with every kernel's twin (``twins``) at the
    flagship's tolerance; row 0 within 1e-2 of max|y| of the port's
    float64 run on the CPU; the median of 3 calls, the busy share, the
    loop's host time and the scan kernel's device time a call."""
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import mlsa, newton, recurrence, scan

    B, T = xs.shape
    voc = MelCepstralVocoder(mode="pade-approx", device="cuda",
                             dtype=torch.float32)
    loop_s, loop_work = [], [0, 0.0]
    loop = recurrence._scan_sample_wise_lpc

    def timed_loop(x, a, *args):
        t0 = time.perf_counter()
        out = loop(x, a, *args)
        loop_s.append(time.perf_counter() - t0)
        # x and a read once, y written once; a complex multiply-add is 8
        loop_work[0] += nbytes(x, a, out)
        loop_work[1] += 8 * a.numel()
        return out

    with torch.no_grad():
        sink = []
        restore = record_calls(scan, "first_order_scan", sink)
        newton.launches = mlsa.launches = scan.launches = 0
        try:
            y = voc.analysis_synthesis(xs)
            torch.cuda.synchronize()
        finally:
            restore()
        launches = {"newton": newton.launches, "mlsa_cascade": mlsa.launches,
                    "scan": scan.launches}
        dtypes = sorted({str(args[1].dtype) for args, _ in sink})
        check(launches == {"newton": 10, "mlsa_cascade": 0, "scan": 10}
              and dtypes == ["torch.complex64"],
              f"[pade] launches {launches} on {dtypes}, expected the scan "
              f"10 times on complex64 and Newton 10")
        shapes = sorted({tuple(args[1].shape) for args, _ in sink})
        scan_err = 0.0
        for args, kwargs in sink:
            y_k = scan.first_order_scan(*args, **kwargs)
            y_p = scan.first_order_scan_plain(*args, **kwargs)
            e = float((y_k - y_p).abs().max())
            scan_err = max(scan_err, e)
            check(bool(torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4)),
                  f"[pade] a scan of {tuple(y_k.shape)} disagrees with its "
                  f"twin: {e:.3e} (tol 1e-4)")
        del sink, y_k, y_p
        with twins():
            y_twin = voc.analysis_synthesis(xs)
        tol_y = 1e-2                  # the flagship's bar for two paths
        twin_scale = float(y_twin.abs().max())
        err_twin = float((y - y_twin).abs().max())
        check(bool(torch.allclose(y, y_twin, rtol=0,
                                  atol=tol_y * twin_scale)),
              f"[pade] output disagrees with the twin path: {err_twin:.3e} "
              f"(tol {tol_y} * {twin_scale:.3f})")
        del y_twin
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all()),
              "[pade] output is not finite or has the wrong shape")
        x1 = xs[:1]
        y64 = MelCepstralVocoder(mode="pade-approx", device="cpu",
                                 dtype=torch.float64).analysis_synthesis(
            x1.double().cpu())
        err = rel_err(torch, y[:1], y64)
        check(err <= 1e-2, f"[pade] row 0 against float64 on the CPU "
              f"{err:.3e} of max|y| (bar 1e-2)")
        snr = snr_db(torch, xs, y)
        calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs), 3,
                             warm=1)
        recurrence._scan_sample_wise_lpc = timed_loop
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            voc.analysis_synthesis(xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            recurrence._scan_sample_wise_lpc = loop
        scan_dev, _ = kernel_device_ms(
            torch, lambda: voc.analysis_synthesis(xs), "scan_kernel",
            calls=1)
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: voc.analysis_synthesis(xs), calls=1)
    med = float(np.median(calls))
    loop_bound, loop_by = bound_ms(*loop_work)
    print(f"[pade] B={B} T={T} (pade_order 5, cep_order_mlsa 199): launches "
          f"{launches}, the scan on {dtypes} of {shapes}, each against its "
          f"twin on its own inputs {scan_err:.3e} (tol 1e-4); |y kernel-"
          f"twin| {err_twin:.3e} (tol {tol_y} * {twin_scale:.3f}); row 0 "
          f"against float64 on the "
          f"CPU {err:.3e} of max|y| (bar 1e-2); SNR against x {snr:.2f} dB; "
          f"median {med:.3f} ms per call ({len(calls)} calls: "
          + ", ".join(f"{v:.3f}" for v in calls)
          + f"), {B * T / (med * 1e-3):.1f} samples/s; the order-199 "
          f"sections' per-sample loop: {len(loop_s)} loops, host time "
          f"{1e3 * sum(loop_s):.3f} ms of a {1e3 * wall:.3f} ms call, its "
          f"bound {loop_bound:.4f} ms ({loop_by}); the scan kernel's "
          f"device time {scan_dev:.4f} ms a call; "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:4])
          + f" | {card}", flush=True)


# [features]: SPTK's command defaults for mfcc and plp (order 12, 20
# channels, lifter 22) at the flagship's frame grid, and PLP at order 24
# with 40 channels, whose Levinson-Durbin takes the SPD solve kernel.
FEATURES = dict(fft_length=512, sample_rate=16000, lifter=22)


def feature_ops(torch, device, dtype) -> dict:
    """[features]' analyses of a power spectrum."""
    import diffsptk_tpu_torch as pt

    kw = dict(FEATURES, device=device, dtype=dtype)
    return {"mfcc": pt.MFCC(mfcc_order=12, n_channel=20, **kw),
            "plp": pt.PLP(plp_order=12, n_channel=20, **kw),
            "plp24": pt.PLP(plp_order=24, n_channel=40, **kw)}


def power_spectrum(torch, xs):
    """The flagship's STFT 400/80/512 power spectrum of ``xs``."""
    import diffsptk_tpu_torch as pt

    return pt.STFT(400, 80, 512, out_format="power", device=xs.device,
                   dtype=xs.dtype)(xs)


# [features]' bars: row 0 of the card's float32 against float64 on the
# CPU on the same spectrum, of max|.|.  Ten times a float32 CPU run's
# reading (row 0 of the same signal), rounded up to a power of ten.
FEATURE_BARS = {"mfcc": 1e-5, "plp": 1e-4, "plp24": 1e-4}


def run_features(torch, xs, card: str):
    """[features]: MFCC, PLP and PLP-24 of the flagship's power spectrum
    (32 x 19,200 samples: 32 x 241 frames), float32 on the card: the SPD
    solve kernel 1 launch for PLP-24 and none for the others; each output
    against the call with every kernel's twin (1e-4 of max); row 0
    against float64 on the CPU (FEATURE_BARS); finite, non-zero gradients
    (2 solve launches with PLP-24's backward); each analysis' median and
    p90 of 20 calls and its busy share; the kernel's device time at this
    call against its bound.  Returns the power spectrum and PLP-24's and
    MFCC's outputs, which [griffin] and [ops-rest] take."""
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import solve

    B, T = xs.shape
    ops = feature_ops(torch, "cuda", torch.float32)
    ops64 = feature_ops(torch, "cpu", torch.float64)
    with torch.no_grad():
        sp = power_spectrum(torch, xs)
        out, launches = {}, {}
        for name, op in ops.items():
            solve.launches = 0
            out[name] = op(sp)
            torch.cuda.synchronize()
            launches[name] = solve.launches
        check(launches == {"mfcc": 0, "plp": 0, "plp24": 1},
              f"[features] solve kernel launches {launches}, expected 1 "
              f"for plp24 and none for the others")
        for name, y in out.items():
            check(bool(torch.isfinite(y).all()),
                  f"[features] {name} is not finite")
        with twins():
            twin = {name: op(sp) for name, op in ops.items()}
        err_twin = {name: rel_err(torch, out[name], twin[name].double())
                    for name in ops}
        for name, e in err_twin.items():
            check(e <= 1e-4, f"[features] {name} of the kernel path "
                  f"disagrees with the twin path: {e:.3e} of max")
        sp64 = sp[:1].double().cpu()
        err64 = {name: rel_err(torch, out[name][:1], op(sp64))
                 for name, op in ops64.items()}
        for name, e in err64.items():
            check(e <= FEATURE_BARS[name],
                  f"[features] {name} row 0 against float64 on the CPU: "
                  f"{e:.3e} of max (bar {FEATURE_BARS[name]})")
        ms, busy = {}, {}
        for name, op in ops.items():
            calls = cuda_call_ms(torch, lambda op=op: op(sp), 20)
            ms[name] = (float(np.median(calls)),
                        float(np.percentile(calls, 90)))
            b_ms, _, n_dev, _, w_ms = profile_chain(
                torch, lambda op=op: op(sp))
            busy[name] = (busy_share(b_ms, w_ms), n_dev)
        solve_dev = kernel_device_ms(torch, lambda: ops["plp24"](sp),
                                     "spd_solve_kernel")[0]
    n, frames = 24, B * sp.shape[-2]
    solve_bound, solve_by = bound_ms(
        (n * (n + 1) // 2 + 2 * n) * frames * 4.0,
        frames * (n ** 3 / 3 + 2 * n ** 2))
    gmax = {}
    for name in ("plp24", "mfcc"):
        spg = sp.clone().requires_grad_(True)
        solve.launches = 0
        ops[name](spg).sum().backward()
        torch.cuda.synchronize()
        if name == "plp24":
            grad_launches = solve.launches
        gmax[name] = float(spg.grad.abs().max())
        check(bool(torch.isfinite(spg.grad).all()) and gmax[name] > 0,
              f"[features] {name} gradient is not finite or is zero")
    check(grad_launches == 2,
          f"[features] PLP-24 with its backward launched the solve kernel "
          f"{grad_launches} times, expected 2")
    print(f"[features] B={B} T={T} ({frames} frames of STFT 400/80/512 "
          f"power): solve kernel launches {launches} (plp24 with its "
          f"backward {grad_launches}); kernel path against the twin path "
          + ", ".join(f"{k} {v:.3e}" for k, v in err_twin.items())
          + " of max (tol 1e-4); row 0 against float64 on the CPU "
          + ", ".join(f"{k} {v:.3e} (bar {FEATURE_BARS[k]})"
                      for k, v in err64.items())
          + "; gradients finite, max|dL/dsp| "
          + ", ".join(f"{k} {v:.4e}" for k, v in gmax.items())
          + "; median (p90) ms per call of 20: "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]:.3f})" for k, v in ms.items())
          + "; " + "; ".join(f"{k}: {v[0]} in {v[1]:.0f} device functions "
                             f"per call" for k, v in busy.items())
          + f"; the solve kernel at plp24's call (n=24, B={frames}): device "
          f"{device_rate((n * (n + 1) // 2 + 2 * n) * frames * 4.0, solve_dev, solve_bound)}"
          f", bound {solve_bound:.5f} ms ({solve_by}) | {card}", flush=True)
    return sp, out


# [gammatone]'s bars: row 0 of the card's float32 analysis and synthesis
# against float64 on the CPU on the same input, of max|.|: ten times a
# float32 CPU run's reading, rounded up to a power of ten.  The round
# trip does not invert exactly: its SNR on the interior is 18.4 dB in
# both packages at float64 on 1,600 samples (tests/test_torch_gammatone).
GAMMATONE_BARS = {"analysis": 1e-4, "synthesis": 1e-4}
GAMMATONE_SNR = 15.0


def run_gammatone(torch, xs, card: str) -> int:
    """[gammatone]: GammatoneFilterBankAnalysis(16000) (30 bands) then
    GammatoneFilterBankSynthesis on 32 x 19,200 samples, float32 on the
    card: the scan kernel exactly 4 launches (gamma = 4 one-pole passes),
    all complex64 over 960 rows; each launch against
    ``first_order_scan_plain`` on its recorded inputs at [K5]'s complex64
    tolerance (1e-4); the round trip's SNR on the interior above
    GAMMATONE_SNR; row 0 of both against float64 on the CPU
    (GAMMATONE_BARS); a gradient through both (8 launches with the
    backward); times, busy share, peak memory, and the kernel's device
    time against its bound (the wrapper makes the broadcast pole
    contiguous before each launch, so the kernel reads a full pole array:
    the bound counts those bytes).  Returns the launches of one call."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import scan

    B, T = xs.shape
    kw = dict(device="cuda", dtype=torch.float32)
    ana = pt.GammatoneFilterBankAnalysis(16000, **kw)
    syn = pt.GammatoneFilterBankSynthesis(16000, **kw)
    K = ana.a_tilde.shape[0]
    with torch.no_grad():
        sink = []
        restore = record_calls(scan, "first_order_scan", sink)
        scan.launches = 0
        try:
            sub = ana(xs)
            torch.cuda.synchronize()
        finally:
            restore()
        launches = scan.launches
        dtypes = sorted({str(args[1].dtype) for args, _ in sink})
        shapes = sorted({tuple(args[1].shape) for args, _ in sink})
        check(launches == 4 and len(sink) == 4
              and dtypes == ["torch.complex64"],
              f"[gammatone] scan launches {launches} on {dtypes}, expected "
              f"4 on complex64")
        pole_copy = not sink[0][0][0].is_contiguous()
        scan_err = 0.0
        for args, kwargs in sink:
            y_k = scan.first_order_scan(*args, **kwargs)
            y_p = scan.first_order_scan_plain(*args, **kwargs)
            e = float((y_k - y_p).abs().max())
            scan_err = max(scan_err, e)
            check(bool(torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4)),
                  f"[gammatone] a scan of {tuple(y_k.shape)} disagrees with "
                  f"its twin: {e:.3e} (tol 1e-4)")
        del sink, y_k, y_p
        y = syn(sub)
        check(tuple(sub.shape) == (B, K, T) and tuple(y.shape) == (B, 1, T)
              and bool(torch.isfinite(sub).all())
              and bool(torch.isfinite(y).all()),
              "[gammatone] output is not finite or has the wrong shape")
        inner = slice(800, T - 800)
        snr = snr_db(torch, xs[:, inner], y[:, 0, inner])
        check(snr > GAMMATONE_SNR, f"[gammatone] round-trip SNR {snr:.2f} "
              f"dB (bar {GAMMATONE_SNR})")
        ana64 = pt.GammatoneFilterBankAnalysis(16000, device="cpu",
                                               dtype=torch.float64)
        syn64 = pt.GammatoneFilterBankSynthesis(16000, device="cpu",
                                                dtype=torch.float64)
        sub64 = ana64(xs[:1].double().cpu())
        err64 = {"analysis": rel_err(torch, sub[:1], sub64),
                 "synthesis": rel_err(torch, y[:1], syn64(sub64))}
        for name, e in err64.items():
            check(e <= GAMMATONE_BARS[name],
                  f"[gammatone] {name} row 0 against float64 on the CPU: "
                  f"{e:.3e} of max (bar {GAMMATONE_BARS[name]})")
        del sub64
        calls = cuda_call_ms(torch, lambda: syn(ana(xs)), 10)
        ana_ms = float(np.median(cuda_call_ms(torch, lambda: ana(xs), 10)))
        scan_dev, _ = kernel_device_ms(torch, lambda: ana(xs), "scan_kernel",
                                       calls=5)
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: syn(ana(xs)))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        syn(ana(xs))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    xg = xs[:4].clone().requires_grad_(True)
    scan.launches = 0
    (syn(ana(xg)) ** 2).sum().backward()
    torch.cuda.synchronize()
    grad_launches = scan.launches
    gmax = float(xg.grad.abs().max())
    check(grad_launches == 8, f"[gammatone] scan launches with the "
          f"backward {grad_launches}, expected 8")
    check(bool(torch.isfinite(xg.grad).all()) and gmax > 0,
          "[gammatone] gradient is not finite or is zero")
    R = B * K
    scan_bytes = 3 * R * T * 8.0
    scan_bound, scan_by = bound_ms(scan_bytes, 8.0 * R * T)
    med = float(np.median(calls))
    print(f"[gammatone] B={B} T={T}, {K} bands: scan launches {launches} "
          f"on {dtypes} of {shapes}, each against its twin on its own "
          f"inputs {scan_err:.3e} (tol 1e-4); the pole reaches the wrapper "
          f"{'broadcast, and the wrapper copies it contiguous' if pole_copy else 'contiguous'}"
          f" ({R * T * 8 / 1e6:.1f} MB a launch); round-trip SNR on the "
          f"interior {snr:.2f} dB (bar {GAMMATONE_SNR}); row 0 against "
          f"float64 on the CPU "
          + ", ".join(f"{k} {v:.3e} (bar {GAMMATONE_BARS[k]})"
                      for k, v in err64.items())
          + f"; gradient (B=4): scan launches with the backward "
          f"{grad_launches}, finite, max|dL/dx| {gmax:.4e}; median "
          f"{med:.3f} ms per call (p90 "
          f"{float(np.percentile(calls, 90)):.3f}, {len(calls)} calls), "
          f"the analysis alone {ana_ms:.3f} ms; the scan kernel's device "
          f"time {scan_dev:.4f} ms a call ({launches} launches; "
          f"{device_rate(launches * scan_bytes, scan_dev, launches * scan_bound)}"
          f"), bound {scan_bound:.4f} ms a launch ({scan_by}: p, x read "
          f"and y written once, complex64); {busy_share(busy_ms, wall_ms)} "
          f"in {n_device:.0f} device functions per call; peak memory "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above "
          f"the {base / 2 ** 30:.3f} held before); top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:5])
          + f" | {card}", flush=True)
    return launches


def spectral_convergence(torch, stft, s, y) -> float:
    """|| s - |STFT(y)| ||_F / || s ||_F over the whole batch."""
    mag = stft(y).abs()[..., : s.shape[-2], :]
    return float(torch.linalg.vector_norm(s - mag)
                 / torch.linalg.vector_norm(s))


def run_griffin(torch, sp, T: int, card: str) -> None:
    """[griffin]: GriffinLim(400, 80, 512) at its default 100 iterations
    on [features]' power spectrum, float32 on the card: the initial phase
    equal to 2 pi ``utils/prng.uniform`` (JAX's stream) bit for bit; the
    spectral convergence after 100 iterations below that after 1; the
    output against the twin path within 1e-2 of max|y|; the median of 3
    calls and the busy share."""
    import math

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.utils import prng

    B = sp.shape[0]
    kw = dict(device="cuda", dtype=torch.float32)
    gl = pt.GriffinLim(400, 80, 512, **kw)
    gl1 = pt.GriffinLim(400, 80, 512, n_iter=1, **kw)
    stft = pt.STFT(400, 80, 512, out_format="complex", **kw)
    with torch.no_grad():
        s = torch.sqrt(sp + 1e-16)
        phase = gl.phase_generator(s)
        want = 2 * math.pi * prng.uniform(prng.PRNGKey(0, device=s.device),
                                          s.shape, s.dtype)
        check(bool(torch.equal(phase, want)),
              "[griffin] initial phase differs from prng.uniform's")
        y = gl(sp, T)
        check(tuple(y.shape) == (B, T) and bool(torch.isfinite(y).all()),
              "[griffin] output is not finite or has the wrong shape")
        sc1 = spectral_convergence(torch, stft, s, gl1(sp, T))
        sc100 = spectral_convergence(torch, stft, s, y)
        check(sc100 < sc1, f"[griffin] spectral convergence {sc100:.4f} "
              f"after 100 iterations, {sc1:.4f} after 1")
        with twins():
            y_twin = gl(sp, T)
        err_twin = rel_err(torch, y, y_twin.double())
        check(err_twin <= 1e-2, f"[griffin] output disagrees with the twin "
              f"path: {err_twin:.3e} of max|y| (tol 1e-2)")
        calls = cuda_call_ms(torch, lambda: gl(sp, T), 3, warm=1)
        busy_ms, top, n_device, _, wall_ms = profile_chain(
            torch, lambda: gl(sp, T), calls=1)
    med = float(np.median(calls))
    print(f"[griffin] B={B} T={T} (400/80/512, 100 iterations): initial "
          f"phase equal to 2 pi prng.uniform; spectral convergence "
          f"{sc1:.4f} after 1 iteration, {sc100:.4f} after 100; against the "
          f"twin path {err_twin:.3e} of max|y| (tol 1e-2; no kernel on "
          f"this path); median {med:.3f} ms per call ({len(calls)} calls: "
          + ", ".join(f"{v:.3f}" for v in calls)
          + f"), {med / 100:.4f} ms an iteration; "
          f"{busy_share(busy_ms, wall_ms)} in {n_device:.0f} device "
          f"functions per call; top device time: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:4])
          + f" | {card}", flush=True)


def ops_rest_ops(torch, device, dtype, frames: int = 240) -> dict:
    """[ops-rest]'s modules at the flagship's shapes (``frames`` frames a
    row): each a function of the inputs that ``ops_rest_inputs`` gives
    it."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    ops = {name.lower(): getattr(pt, name)(256, **kw)
           for name in ("DCT", "IDCT", "DST", "IDST", "DHT", "IDHT", "WHT")}
    dtw = pt.DTW(p=4, **kw)
    ops.update({
        "chroma": pt.ChromaFilterBankAnalysis(fft_length=512, n_channel=12,
                                              sample_rate=16000, **kw),
        "drc": pt.DRC(sample_rate=16000, threshold=-30, ratio=4, **kw),
        "alaw": pt.ALawCompression(**kw), "ialaw": pt.ALawExpansion(**kw),
        "ulaw": pt.MuLawCompression(**kw), "iulaw": pt.MuLawExpansion(**kw),
        "quantize": pt.UniformQuantization(**kw),
        "dequantize": pt.InverseUniformQuantization(**kw),
        "delta": pt.Delta([[-0.5, 0.0, 0.5], [1.0, -2.0, 1.0]], **kw),
        "mlpg": pt.MLPG(frames, **kw),
        "iir": pt.IIR(b=[1.0, 0.5], a=[1.0, -1.6, 0.8], **kw),
        "biquad": pt.SecondOrderDigitalFilter(
            16000, pole_frequency=1000, pole_bandwidth=200,
            zero_frequency=3000, zero_bandwidth=300, **kw),
        "dtw": dtw,
        "dtw-path": lambda x, y: dtw(x, y, return_indices=True)[1][0],
    })
    return ops


def ops_rest_inputs(torch, ops, xs, sp, mfcc, plp24) -> dict:
    """Each module's inputs (a tuple), on ``xs``' device, from the
    signal, [features]' power spectrum, MFCC and PLP-24 and the modules'
    outputs: the DCT family on the log spectrum's first 256 bins, DTW
    between rows 0 and 1 of PLP-24 (two sequences of 240 frames of order
    24)."""
    logsp = torch.log(sp[..., :256])
    inputs = {name: (logsp,) for name in ("dct", "idct", "dst", "idst",
                                          "dht", "idht", "wht")}
    inputs.update({
        "chroma": (sp,), "drc": (xs,), "alaw": (xs,),
        "ialaw": (ops["alaw"](xs),), "ulaw": (xs,),
        "iulaw": (ops["ulaw"](xs),), "quantize": (xs,),
        "dequantize": (ops["quantize"](xs),), "delta": (mfcc,),
        "mlpg": (ops["delta"](mfcc),), "iir": (xs,), "biquad": (xs,),
        "dtw": (plp24[0], plp24[1]), "dtw-path": (plp24[0], plp24[1])})
    return inputs


def row0(name, args):
    """A module's inputs cut to row 0 (DTW's are one pair already)."""
    return args if name.startswith("dtw") else tuple(a[:1] for a in args)


# [ops-rest]'s bars: max |card float32 - CPU float64| over max|CPU
# float64| on row 0 of the same inputs.  Ten times a float32 CPU run's
# reading, rounded up to a power of ten (the dequantizer's arithmetic is
# exact: 0 on the CPU, bar 1e-6); the quantizer's floor may move a sample
# by one of its 256 levels where x sits on a level's edge (0 on the CPU,
# bar 1e-2).
OPS_REST_BARS = {
    "dct": 1e-5, "idct": 1e-5, "dst": 1e-5, "idst": 1e-5, "dht": 1e-5,
    "idht": 1e-5, "wht": 1e-5, "chroma": 1e-5, "drc": 1e-5, "alaw": 1e-5,
    "ialaw": 1e-5, "ulaw": 1e-5, "iulaw": 1e-5, "quantize": 1e-2,
    "dequantize": 1e-6, "delta": 1e-6, "mlpg": 1e-5, "iir": 1e-5,
    "biquad": 1e-4, "dtw": 1e-5}
# The modules of [ops-rest] that read the card back by design: the hard
# DTW path is backtracked on the host in numpy, as in the JAX package.
OPS_REST_HOST_STEPS = ("dtw-path",)


def run_ops_rest(torch, xs, sp, mfcc, plp24, card: str) -> None:
    """[ops-rest]: every other module of this slice once on the card at
    the flagship's shapes, float32, on the signal and [features]'
    outputs: each against the port's float64 run on the CPU on row 0 of
    the same inputs within its bar (OPS_REST_BARS); no module but
    OPS_REST_HOST_STEPS reads the card back (set_sync_debug_mode("error")
    around each call, after a first call); the DTW path runs from (0, 0)
    to the last frames in the constraint's steps; each module's median time
    (5 calls; DRC and DTW, host-bound loops, one call)."""
    from diffsptk_tpu_torch.kernels import scan, solve

    frames = sp.shape[-2]
    ops = ops_rest_ops(torch, "cuda", torch.float32, frames)
    ops64 = ops_rest_ops(torch, "cpu", torch.float64, frames)
    on_card = [name for name in ops if name not in OPS_REST_HOST_STEPS]
    with torch.no_grad():
        inputs = ops_rest_inputs(torch, ops, xs, sp, mfcc, plp24)
        for name in on_card:
            ops[name](*inputs[name])
        torch.cuda.synchronize()
        scan.launches = solve.launches = 0
        out, synced = {}, []
        for name in on_card:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out[name] = ops[name](*inputs[name])
            except RuntimeError as exc:
                if "synchroniz" not in str(exc):
                    raise
                synced.append(name)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(not synced, f"[ops-rest] host reads in {synced}")
        torch.cuda.synchronize()
        kernel_launches = {"scan": scan.launches, "spd_solve": solve.launches}
        ms = {}
        for name in on_card:
            once = name in ("drc", "dtw")
            ms[name] = float(np.median(cuda_call_ms(
                torch, lambda op=ops[name], a=inputs[name]: op(*a),
                1 if once else 5, warm=0 if once else 1)))
        for name in OPS_REST_HOST_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = ops[name](*inputs[name])
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
        errs = {}
        for name in on_card:
            want = ops64[name](*(a.double().cpu()
                                 for a in row0(name, inputs[name])))
            got = out[name] if name == "dtw" else out[name][:1]
            check(bool(torch.isfinite(out[name]).all()),
                  f"[ops-rest] {name} is not finite")
            errs[name] = rel_err(torch, got, want)
            check(errs[name] <= OPS_REST_BARS[name],
                  f"[ops-rest] {name} against float64 on the CPU: "
                  f"{errs[name]:.3e} of max (bar {OPS_REST_BARS[name]})")
        path = out["dtw-path"].cpu()
        steps = {tuple(s) for s in (path[1:] - path[:-1]).tolist()}
        path64 = ops64["dtw-path"](*(a.double().cpu()
                                     for a in inputs["dtw-path"])).cpu()
        last = (inputs["dtw"][0].shape[0] - 1, inputs["dtw"][1].shape[0] - 1)
        check(tuple(path[0].tolist()) == (0, 0)
              and tuple(path[-1].tolist()) == last
              and steps <= {(1, 0), (0, 1), (1, 1)},
              f"[ops-rest] the DTW path is not a path of constraint 4: "
              f"from {path[0].tolist()} to {path[-1].tolist()}, steps "
              f"{sorted(steps)}")
        same = len({tuple(p) for p in path.tolist()}
                   & {tuple(p) for p in path64.tolist()})
    print(f"[ops-rest] B={xs.shape[0]} T={xs.shape[1]} (the DCT family at "
          f"256 points on {frames} frames a row, DTW between two "
          f"{frames}-frame order-24 PLP sequences), float32 against float64 on the CPU, "
          f"row 0, of max|.|: "
          + ", ".join(f"{k} {v:.3e} (bar {OPS_REST_BARS[k]})"
                      for k, v in errs.items())
          + f"; the DTW path {len(path)} cells from (0, 0) to {last}, "
          f"{same} of them on the float64 path's {len(path64)}; kernel "
          f"launches {kernel_launches} (none expected); no host read but in "
          f"{list(OPS_REST_HOST_STEPS)} (not checked); median ms per call "
          f"(5 calls; drc, dtw one call; {list(OPS_REST_HOST_STEPS)} one "
          f"call, host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" | {card}", flush=True)



# --- [learners], [misc], [functional], [io] ---------------------------------

class HostReads:
    """Counts the card's synchronising calls in a block: torch's sync
    debug mode warns at each (a read back to the host, a blocking copy),
    and the warnings are counted.  On the CPU it counts nothing
    (``count`` stays None).  ``where`` lists the lines that read."""

    def __init__(self, torch, device) -> None:
        self.torch = torch
        self.on_card = torch.device(device).type == "cuda"
        self.count, self.where = None, []

    def __enter__(self):
        import warnings

        if self.on_card:
            self._caught = warnings.catch_warnings(record=True)
            self._log = self._caught.__enter__()
            warnings.simplefilter("always")
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self.torch.cuda.set_sync_debug_mode("default")
            self._caught.__exit__(*exc)
            syncs = [w for w in self._log
                     if "called a synchronizing" in str(w.message)]
            self.count = len(syncs)
            self.where = sorted({f"{w.filename.rsplit('/', 1)[-1]}:"
                                 f"{w.lineno}" for w in syncs})
        return False


def timed_reads(torch, fn, device) -> tuple[float, object, HostReads]:
    """Host-clock ms of one call of ``fn`` until the card has finished, its
    result, and the ``HostReads`` of the call (the closing synchronize is
    not counted)."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with HostReads(torch, device) as hr:
        out = fn()
    if on_card:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out, hr


def learner_data(torch, B: int, T: int, device) -> dict:
    """[learners]' data: ``synth_speech(B, T)`` (rows of the flagship's
    19,200 samples), its mel-cepstra (order 24, alpha 0.42, 10 Newton
    steps, 240 frames a row) and those of a second rendering of it (the
    same signal in white noise at about 30 dB, whose spectral valleys
    fill: a frame-wise, nonlinear relation, as a target speaker's to a
    source's), the power spectrum of its first 32 rows (240 frames a row,
    257 bins), and four sources of 32 x 19,200 samples each (rows of
    ``synth_speech``) mixed by a fixed 4 x 4 matrix."""
    import diffsptk_tpu_torch as pt

    xs = torch.as_tensor(synth_speech(B, T), device=device)
    noise = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (B, T)).astype(np.float32), device=device)
    voc = pt.MelCepstralVocoder(cascade="fused", device=device,
                                dtype=torch.float32)
    frames = T // 80
    mx, my = [], []
    with torch.no_grad():
        for i in range(0, B, 32):
            x = xs[i:i + 32]
            mx.append(voc.analyze(x)[:, :frames])
            my.append(voc.analyze(x + 5e-3 * noise[i:i + 32])[:, :frames])
        sp = power_spectrum(torch, xs[:32])[:, :frames]
    L = mx[0].shape[-1]
    n_src = min(32 * T, 614_400)
    src = torch.as_tensor(synth_speech(4, n_src).T.copy(), device=device)
    mixing = torch.as_tensor(np.array(
        [[1.0, 0.6, 0.3, 0.2], [0.4, 1.0, 0.5, 0.1], [0.2, 0.3, 1.0, 0.6],
         [0.5, 0.1, 0.4, 1.0]], np.float32), device=device)
    return {"mc_x": torch.cat(mx).reshape(-1, L),
            "mc_y": torch.cat(my).reshape(-1, L),
            "sp": sp.reshape(-1, sp.shape[-1]).contiguous(),
            "sources": src, "mixed": src @ mixing.T}


# [learners]' bars: the float32 card run against float64.  The GMM's final
# log-likelihood per frame against the float64 card run from the same
# initialisation.  The LBG's final mean distance against a float64 card
# run on the float32 run's draws, for each of LBG_SEEDS: the two part at
# the first assignment that flips, so the gap measures the whole fit
# (splits, centroid updates and re-seeding).  The eight seeds' gaps lie
# between 3.6e-5 and 1.2e-3 on an NVIDIA H100 80GB HBM3 at 700 W, the
# same in every run, so the bar is 2.5 times the largest.  As a second
# check, the float32 run's final codebook's mean distance against the
# same codebook's recomputed in float64 (the rounding of the assignment
# alone).  The PCA's eigenvalues against the float64 card run's, relative
# to the largest (the smallest of order-24 mel-cepstra are four orders
# of magnitude below it).
LEARNER_BARS = {"gmm": 1e-3, "lbg": 3e-3, "lbg-codebook": 1e-5,
                "pca": 1e-4}
LBG_SEEDS = tuple(range(8))
LEARNER_ITERS = {"gmm": 20, "gmm-warmup": 20, "lbg": 20, "ica": 100,
                 "nmf": 50}


def learner_ops(torch, device, dtype) -> dict:
    """[learners]' learners, fresh: VQ and two-stage VQ (codebook 256,
    order 24), GMM (order 49, 32 mixtures, full covariance in blocks of
    25, voice conversion's joint vectors), LBG (order 24, codebook 256,
    streamed in chunks of 7,680 frames), PCA (order 24, every component),
    ICA (4 sources) and NMF (a power spectrum's 257 bins, 64 components)."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    return {
        "vq": lambda: pt.VectorQuantization(24, 256, **kw),
        "msvq": lambda: pt.MultiStageVectorQuantization(24, 256, 2, **kw),
        "gmm": lambda: pt.GMM(49, 32, n_iter=LEARNER_ITERS["gmm"], eps=0,
                              var_type="full", block_size=[25, 25], **kw),
        "lbg": lambda seed=0: pt.LBG(24, 256, n_iter=LEARNER_ITERS["lbg"],
                                     batch_size=7680, seed=seed, **kw),
        "pca": lambda: pt.PCA(24, 25, **kw),
        "ica": lambda: pt.ICA(3, 4, n_iter=LEARNER_ITERS["ica"], **kw),
        "nmf": lambda n_data: pt.NMF(n_data, 256, 64,
                                     n_iter=LEARNER_ITERS["nmf"], eps=0,
                                     **kw),
    }


class DrawTape:
    """Records an LBG's random draws, then replays them to another LBG
    (cast to its dtype): the float64 run starts from the float32 run's
    perturbations.  A draw of another shape than the tape's next is drawn
    afresh and counted in ``fresh``."""

    def __init__(self) -> None:
        self.draws, self.fresh, self._next = [], 0, 0

    def record(self, lbg) -> None:
        draw = lbg._rand

        def rand(shape, dtype):
            r = draw(shape, dtype)
            self.draws.append(r)
            return r

        lbg._rand = rand

    def replay(self, lbg) -> None:
        draw = lbg._rand

        def rand(shape, dtype):
            if (self._next < len(self.draws)
                    and tuple(self.draws[self._next].shape) == tuple(shape)):
                self._next += 1
                return self.draws[self._next - 1].to(dtype)
            self.fresh += 1
            return draw(shape, dtype)

        lbg._rand = rand


def lbg_fit(torch, lbg, x):
    """One LBG fit with its codebook-size trajectory (one entry an
    iteration)."""
    sizes = []

    def cb(codebook_size, **kw):
        sizes.append(codebook_size)

    cb_, idx, dist = lbg(x, return_indices=True, callback=cb)
    return cb_, idx, float(dist), sizes


def run_learners(torch, data, card: str, device="cuda") -> dict:
    """[learners]: the learners at the width users run, float32 on the
    card: VQ and two-stage VQ on 76,800 mel-cepstra; the GMM on the
    centred joint vectors, warm-started by its LBG (clusters of fewer than
    100 frames re-seeded), fitted (20 EM steps) and its regression of the
    second rendering's mel-cepstra from the first's; LBG to 256 codewords
    twice (the indices and the codebook-size trajectory equal), once for
    each other of LBG_SEEDS, and in float64 from each seed's float32
    draws; PCA; ICA of four mixed sources (each
    recovered component correlates with one source above 0.9); NMF of a
    power spectrum (the divergence falls).  Float32 against float64 from
    one initialisation within LEARNER_BARS; the host reads of each fit
    counted against its docstring's stated reads; ms per iteration and the
    busy share of one fit.  Returns the GMM's parameters, which [io]
    checkpoints."""
    ops = learner_ops(torch, device, torch.float32)
    ops64 = learner_ops(torch, device, torch.float64)
    mc_x = data["mc_x"]
    # Voice conversion's joint vectors, centred over the frames as its
    # front ends normalise them: raw float32 second moments of uncentred
    # mel-cepstra lose a component's positive definiteness within 20 EM
    # steps (on the CPU at 7,680 frames), in either package's formula.
    joint = torch.cat([mc_x, data["mc_y"]], -1)
    joint = (joint - joint.mean(0)).contiguous()
    jx, jy = joint[:, :25], joint[:, 25:]
    n = mc_x.shape[0]
    res, reads, ms, busy = {}, {}, {}, {}

    # VQ and MSVQ: the distance GEMM and argmin; no host read
    with torch.no_grad():
        vq, msvq = ops["vq"](), ops["msvq"]()
        for name, op in (("vq", vq), ("msvq", msvq)):
            op(mc_x)
            ms[name], (xq, idx, loss), reads[name] = timed_reads(
                torch, lambda: op(mc_x), device)
            check(bool(torch.isfinite(xq).all()) and idx.shape[0] == n,
                  f"[learners] {name} output is not finite")
        err_vq = float(loss)

    # GMM: warm start, fit, regression
    gmm = ops["gmm"]()
    t_warm, _, reads["gmm-warmup"] = timed_reads(torch, lambda: gmm.warmup(
        joint, n_iter=LEARNER_ITERS["gmm-warmup"],
        min_data_per_cluster=100), device)
    init = tuple(p.clone() for p in (gmm.w, gmm.mu, gmm.sigma))
    t, ((w, mu, sigma), ll), reads["gmm"] = timed_reads(
        torch, lambda: gmm(joint), device)
    ms["gmm"] = t / LEARNER_ITERS["gmm"]
    gmm64 = ops64["gmm"]()
    gmm64.set_params(tuple(p.double() for p in init))
    (_, _, _), ll64 = gmm64(joint.double())
    res["gmm"] = abs(float(ll) - float(ll64)) / abs(float(ll64))
    E, _, _ = gmm.transform(jx)
    rmse_reg = float(torch.sqrt(((E - jy) ** 2).mean()))
    rmse_id = float(torch.sqrt(((jx - jy) ** 2).mean()))
    check(bool(torch.isfinite(E).all()) and rmse_reg < rmse_id,
          f"[learners] the GMM's regression: rmse {rmse_reg:.4f} against "
          f"{rmse_id:.4f} without it")

    def gmm_fit():
        gmm.set_params(init)
        gmm(joint)

    b, _, _, _, wall = profile_chain(torch, gmm_fit, calls=1) \
        if device == "cuda" else (0.0, 0, 0, 0, 1.0)
    busy["gmm"] = (b, wall)
    params = {"w": w, "mu": mu, "sigma": sigma}

    # LBG: two float32 runs of seed 0, one of each other seed, and a
    # float64 run on each seed's float32 draws
    tapes = {seed: DrawTape() for seed in LBG_SEEDS}
    lbg = ops["lbg"]()
    tapes[0].record(lbg)
    t, (cb1, idx1, d1, sizes1), reads["lbg"] = timed_reads(
        torch, lambda: lbg_fit(torch, lbg, mc_x), device)
    ms["lbg"] = t / len(sizes1)
    cb2, idx2, d2, sizes2 = lbg_fit(torch, ops["lbg"](), mc_x)
    check(sizes1 == sizes2 and bool(torch.equal(idx1, idx2)),
          "[lbg] two runs on the card took different decisions: "
          f"{len(sizes1)} and {len(sizes2)} iterations, "
          f"{int((idx1 != idx2).sum())} indices differ")
    same_cb = bool(torch.equal(cb1, cb2))
    d32 = {0: d1}
    for seed in LBG_SEEDS[1:]:
        op = ops["lbg"](seed)
        tapes[seed].record(op)
        d32[seed] = lbg_fit(torch, op, mc_x)[2]
    gap, iters64 = {}, {}
    for seed in LBG_SEEDS:
        op = ops64["lbg"](seed)
        tapes[seed].replay(op)
        _, _, d64, sizes64 = lbg_fit(torch, op, mc_x.double())
        gap[seed] = abs(d32[seed] - d64) / d64
        iters64[seed] = len(sizes64)
    res["lbg"] = max(gap.values())
    fresh = sum(tape.fresh for tape in tapes.values())
    # how far apart independent float32 fits end: what the bar is set
    # against
    spread = (max(d32.values()) - min(d32.values())) / min(d32.values())
    # the final codebook's mean distance in float32 on the card (its
    # returned indices) against the same codebook's in float64
    with torch.no_grad():
        d_32 = float(((mc_x - cb1[idx1]) ** 2).sum(-1).mean())
        x64, cb64 = mc_x.double(), cb1.double()
        d_cb = float(((x64 - cb64[torch.cdist(x64, cb64).argmin(-1)]) ** 2)
                     .sum(-1).mean())
    res["lbg-codebook"] = abs(d_32 - d_cb) / d_cb
    b, _, _, _, wall = profile_chain(
        torch, lambda: ops["lbg"]()(mc_x), calls=1) \
        if device == "cuda" else (0.0, 0, 0, 0, 1.0)
    busy["lbg"] = (b, wall)

    # PCA
    pca = ops["pca"]()
    pca(mc_x)                      # the first eigensolver call sets up
    ms["pca"], (s32, _, _), reads["pca"] = timed_reads(
        torch, lambda: pca(mc_x), device)
    s64, _, _ = ops64["pca"]()(mc_x.double())
    res["pca"] = float((s32.double() - s64).abs().max() / s64.abs().max())

    # ICA
    ica = ops["ica"]()
    iters = []
    t, _, reads["ica"] = timed_reads(torch, lambda: ica(
        data["mixed"], callback=lambda iteration, **kw:
        iters.append(iteration)), device)
    ms["ica"] = t / len(iters)
    rec = ica.transform(data["mixed"]).double()
    src = data["sources"].double()
    rec = (rec - rec.mean(0)) / rec.std(0)
    src = (src - src.mean(0)) / src.std(0)
    corr = (rec.T @ src / rec.shape[0]).abs()
    sep = float(corr.max(dim=1).values.min())
    check(sep > 0.9, f"[learners] ICA: a component correlates {sep:.3f} "
          "at most with any source (bar 0.9)")

    # NMF
    sp = data["sp"]
    nmf = ops["nmf"](sp.shape[0])
    divs = []
    t, _, reads["nmf"] = timed_reads(torch, lambda: nmf(
        sp, callback=lambda divergence, **kw: divs.append(divergence)),
        device)
    ms["nmf"] = t / len(divs)
    check(all(np.isfinite(divs)) and divs[-1] < divs[0],
          f"[learners] NMF's divergence went {divs[0]:.4e} -> "
          f"{divs[-1]:.4e}")
    b, _, _, _, wall = profile_chain(
        torch, lambda: ops["nmf"](sp.shape[0])(sp), calls=1) \
        if device == "cuda" else (0.0, 0, 0, 0, 1.0)
    busy["nmf"] = (b, wall)

    # the stated host reads (each class' docstring)
    stated = {"vq": 0, "msvq": 0, "gmm": LEARNER_ITERS["gmm"],
              "pca": 1, "ica": 2 + 2 * len(iters), "nmf": 1 + len(divs)}
    sites = {k: hr.where for k, hr in reads.items() if hr.where}
    reads = {k: hr.count for k, hr in reads.items()}
    failed = [f"{name} float32 against float64: {res[name]:.3e} (bar "
              f"{bar})" for name, bar in LEARNER_BARS.items()
              if not res[name] <= bar]
    starved = None
    if device == "cuda":
        failed += [f"{name} read the card back {reads[name]} times, stated "
                   f"{count}" for name, count in stated.items()
                   if reads[name] > count]
        extra = reads["lbg"] - len(sizes1)
        if extra < 0 or extra % 2:
            failed.append(f"LBG read the card back {reads['lbg']} times in "
                          f"{len(sizes1)} iterations")
        starved = extra // 2
    print(f"[learners] {n} frames (ten flagship calls), float32 on the "
          f"card: GMM (order 49, 32 mixtures, full in 25 x 25 blocks, "
          f"{LEARNER_ITERS['gmm']} EM steps) log-likelihood per frame "
          f"{float(ll) / n:.5f}, against float64 {res['gmm']:.3e} (bar "
          f"{LEARNER_BARS['gmm']}), regression rmse {rmse_reg:.4f} (without "
          f"it {rmse_id:.4f}); LBG (256, chunks of 7,680) {len(sizes1)} "
          f"iterations, final distance {d_32:.5f}; against a float64 run "
          f"on its draws, seeds " + ", ".join(
              f"{seed} {gap[seed]:.3e} ({iters64[seed]} iterations)"
              for seed in LBG_SEEDS)
          + f" (bar {LEARNER_BARS['lbg']}; {fresh} draws afresh; the "
          f"seeds' float32 fits end {spread:.3e} apart); its "
          f"codebook's distance against float64 {res['lbg-codebook']:.3e} "
          f"(bar {LEARNER_BARS['lbg-codebook']}); two runs: "
          f"indices and trajectory equal, codebooks "
          f"{'equal' if same_cb else 'differ'}; PCA eigenvalues against "
          f"float64 {res['pca']:.3e} of the largest (bar "
          f"{LEARNER_BARS['pca']}); ICA {len(iters)} iterations, each "
          f"component correlates >= {sep:.3f} with a source; NMF "
          f"(7,680 x 257, 64 components) divergence {divs[0]:.4e} -> "
          f"{divs[-1]:.4e}; VQ loss {err_vq:.4f}; host reads (stated) "
          + ", ".join(f"{k} {reads[k]} ({stated.get(k, '-')})"
                      for k in reads)
          + f", LBG {starved} iterations re-seeding starved clusters; ms a "
          f"fit step (host clock, reads included): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f", GMM warm start {t_warm:.1f} ms; "
          + "; ".join(f"{k} {busy_share(*v)}" for k, v in busy.items())
          + f" | {card}", flush=True)
    check(not failed, "[learners] " + "; ".join(failed)
          + f"; the lines that read: {sites}")
    return params


def f0_tracks(B: int, frames: int) -> tuple[np.ndarray, np.ndarray]:
    """[misc]'s f0: ``synth_f0`` at the frame rate (one value every 80
    samples) with unvoiced stretches (0), and a second track 2 % off with
    its own stretches, as a tracker's against the truth."""
    f0 = synth_f0(B, frames * 80)[:, ::80].astype(np.float32)
    t = np.arange(frames)
    a = np.where((t % 40) < 8, 0.0, f0)
    b = np.where(((t + 3) % 40) < 9, 0.0, f0 * 1.02)
    return a.astype(np.float32), b.astype(np.float32)


def misc_ops(torch, device, dtype) -> dict:
    """[misc]'s modules: each a function of the inputs ``misc_inputs``
    gives it."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    return {
        "decimate": pt.Decimation(80, **kw),
        "interpolate": pt.Interpolation(80, **kw),
        "delay": pt.Delay(40, keeplen=True, **kw),
        "entropy": pt.Entropy("bit", **kw),
        "histogram": pt.Histogram(32, -1.0, 1.0, norm=True, softness=1e-2,
                                  **kw),
        "snr": pt.SNR(80, full=True, reduction="none", **kw),
        "rmse": pt.RMSE("none", **kw),
        "flux": pt.Flux(reduction="none", **kw),
        "zcross": pt.ZeroCrossingAnalysis(80, norm=True, **kw),
        "grpdelay": pt.GroupDelay(512, **kw),
        "phase": pt.Phase(512, unwrap=True, **kw),
        "yingram": pt.Yingram(400, 16000, **kw),
        "medfilt": pt.MedianFilter(5, magic_number=0.0, **kw),
        "magic_intpl": pt.MagicNumberInterpolation(0.0, **kw),
        "f0eval": pt.F0Evaluation("none", "f0-rmse-cent", **kw),
    }


def misc_inputs(torch, xs, f0a, f0b) -> dict:
    """Each module's inputs (a tuple) from the signal and two f0 tracks:
    frames of 400 every 80 samples, their log power spectrum (512 bins)
    and order-24 LPC."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=xs.device, dtype=xs.dtype)
    frames = pt.Frame(400, 80, **kw)(xs)
    logsp = torch.log(power_spectrum(torch, xs))
    lpc = pt.LPC(400, 24, **kw)(frames)
    p = torch.exp(logsp)
    return {
        "decimate": (xs,), "interpolate": (xs[..., ::80].contiguous(),),
        "delay": (xs,), "entropy": (p / p.sum(-1, keepdim=True),),
        "histogram": (xs,), "snr": (xs, xs + 1e-2 * torch.roll(xs, 1, -1)),
        "rmse": (logsp[:, 1:], logsp[:, :-1]), "flux": (logsp,),
        "zcross": (xs,), "grpdelay": (None, lpc), "phase": (None, lpc),
        "yingram": (frames,), "medfilt": (f0a[..., None],),
        "magic_intpl": (f0a[..., None],), "f0eval": (f0a, f0b)}


# [misc]'s bars: max |card float32 - CPU float64| over max|CPU float64| on
# row 0 of the same inputs.  Ten times a float32 CPU run's reading on row 0
# of the same signal, rounded up to a power of ten (a reading of 0 takes
# 1e-6).  Group delay and phase read 1.7e-3 and 3.6e-3: order-24 LPC
# poles near the unit circle make the delay's denominator small, and the
# unwrapped phase moves by 2 where a float32 step crosses the wrap.
MISC_BARS = {
    "decimate": 1e-6, "interpolate": 1e-6, "delay": 1e-6,
    "entropy": 1e-5, "histogram": 1e-5, "snr": 1e-5, "rmse": 1e-4,
    "flux": 1e-4, "zcross": 1e-6, "grpdelay": 1e-1, "phase": 1e-1,
    "yingram": 1e-4, "medfilt": 1e-6, "magic_intpl": 1e-6, "f0eval": 1e-5}


def run_misc(torch, xs, card: str) -> None:
    """[misc]: the 15 misc modules once each on the card at the flagship's
    shapes (32 x 19,200 samples, 32 x 241 frames; F0 evaluation on
    ``synth_f0``'s tracks), float32, under set_sync_debug_mode("error")
    after a first call: no host read; row 0 against float64 on the CPU
    within MISC_BARS; each module's median ms of 5 calls."""
    B, T = xs.shape
    f0a, f0b = (torch.as_tensor(f, device=xs.device)
                for f in f0_tracks(B, T // 80))
    ops = misc_ops(torch, "cuda", torch.float32)
    ops64 = misc_ops(torch, "cpu", torch.float64)
    with torch.no_grad():
        inputs = misc_inputs(torch, xs, f0a, f0b)
        for name, op in ops.items():
            op(*inputs[name])
        torch.cuda.synchronize()
        out, synced = {}, []
        for name, op in ops.items():
            torch.cuda.set_sync_debug_mode("error")
            try:
                out[name] = op(*inputs[name])
            except RuntimeError as exc:
                if "synchroniz" not in str(exc):
                    raise
                synced.append(name)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(not synced, f"[misc] host reads in {synced}")
        ms = {name: float(np.median(cuda_call_ms(
            torch, lambda op=op, a=inputs[name]: op(*a), 5, warm=1)))
            for name, op in ops.items()}
        inputs64 = misc_inputs(torch, xs[:1].double().cpu(),
                               f0a[:1].double().cpu(),
                               f0b[:1].double().cpu())
        errs = {}
        for name, op in ops.items():
            got = op(*(None if a is None else a[:1]
                       for a in inputs[name]))
            want = ops64[name](*inputs64[name])
            check(bool(torch.isfinite(out[name]).all()),
                  f"[misc] {name} is not finite")
            errs[name] = rel_err(torch, got, want)
            check(errs[name] <= MISC_BARS[name],
                  f"[misc] {name} against float64 on the CPU: "
                  f"{errs[name]:.3e} of max (bar {MISC_BARS[name]})")
    print(f"[misc] B={B} T={T} ({T // 80} frames a row), float32 against "
          f"float64 on the CPU, row 0, of max|.|: "
          + ", ".join(f"{k} {v:.3e} (bar {MISC_BARS[k]})"
                      for k, v in errs.items())
          + "; no host read; median ms per call (5 calls): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" | {card}", flush=True)


def functional_cases(torch) -> dict:
    """One call of each of ``functional``'s 100 functions on small inputs
    (numpy, float64; the derived ones made by the port on the CPU):
    name -> (positional inputs, keyword arguments)."""
    from diffsptk_tpu_torch import functional as F

    rng = np.random.default_rng(61)

    def port(fn, *args, **kw):
        out = fn(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
        return (out[1][0] if isinstance(out, tuple) else out).numpy()

    X = synth_speech(2, 400).astype(np.float64)
    FR = np.stack([X[:, i * 64:i * 64 + 32] for i in range(5)], 1)
    SP = np.abs(np.fft.rfft(FR, n=64)) ** 2 + 1e-6
    C = 0.3 * rng.standard_normal((2, 5, 9)) / np.arange(1, 10)
    R = port(F.acorr, FR, 8)
    A = port(F.levdur, R)
    K = port(F.lpc2par, A)
    W = port(F.lpc2lsp, A)
    CX = port(F.stft, X, frame_length=32, frame_period=16, fft_length=64,
              out_format="complex")
    P = rng.uniform(0.1, 1, (2, 5, 8))
    P = P / P.sum(-1, keepdims=True)
    F0 = np.where(rng.uniform(size=(2, 40)) < 0.3, 0.0,
                  rng.uniform(80, 300, (2, 40)))
    F0B = np.where(rng.uniform(size=(2, 40)) < 0.3, 0.0,
                   F0 * rng.uniform(0.95, 1.05, (2, 40)))
    SEQ = rng.standard_normal((40, 3))
    SEQ[::7] = 0.0
    Y8 = rng.standard_normal((8, 3))
    PATH = port(F.dtw, SEQ[:10], Y8, return_indices=True)
    PITCH = np.where(np.arange(10) % 4 == 0, 0.0,
                     80.0 + np.arange(10))[None]
    CSM = np.concatenate([np.sort(rng.uniform(0.2, 2.8, (2, 2)), -1),
                          rng.uniform(0.5, 1.0, (2, 2))], -1)
    return {
        "frame": ((X, 32, 16), {}),
        "window": ((FR,), {}),
        "unframe": ((FR,), dict(frame_period=16)),
        "fftr": ((FR, 64), {}),
        "ifftr": ((np.fft.rfft(FR, n=64),), {}),
        "spec": ((FR,), dict(fft_length=64)),
        "stft": ((X,), dict(frame_length=32, frame_period=16,
                            fft_length=64)),
        "istft": ((CX,), dict(frame_length=32, frame_period=16,
                              fft_length=64, out_length=400)),
        "dct": ((FR,), {}), "idct": ((FR,), dict(dct_type=3)),
        "dst": ((FR,), dict(dst_type=1)), "idst": ((FR,), {}),
        "dht": ((FR,), {}), "idht": ((FR,), dict(dht_type=4)),
        "wht": ((FR,), dict(wht_type="dyadic")), "iwht": ((FR,), {}),
        "freqt": ((C, 12, 0.42), {}),
        "mc2b": ((C, 0.42), {}), "b2mc": ((C, 0.42), {}),
        "gnorm": ((C, -0.5), {}), "ignorm": ((C,), dict(gamma=-0.5)),
        "alaw": ((X,), {}), "ialaw": ((X,), {}), "ulaw": ((X,), {}),
        "iulaw": ((X,), dict(mu=100)), "quantize": ((X,), {}),
        "dequantize": ((rng.integers(0, 256, (2, 40)).astype(float),), {}),
        "lpc2par": ((A,), {}), "par2lpc": ((K,), {}), "par2is": ((K,), {}),
        "is2par": ((K,), {}), "par2lar": ((K,), {}), "lar2par": ((K,), {}),
        "norm0": ((A,), {}),
        "acorr": ((FR, 8), {}), "levdur": ((R,), {}), "rlevdur": ((A,), {}),
        "lpc": ((FR, 8), {}), "linear_intpl": ((C, 4), {}),
        "poledf": ((X, A, 80), {}), "zerodf": ((X, A, 80), {}),
        "dfs": ((X,), dict(b=[1.0, 0.5], a=[1.0, -0.9])),
        "df2": ((X, 16000), dict(pole_frequency=1000, pole_bandwidth=200)),
        "fftcep": ((SP, 8), {}),
        "c2acr": ((C, 8, 64), {}), "c2mpir": ((C, 16, 64), {}),
        "mpir2c": ((FR[..., :16], 8, 64), {}), "c2ndps": ((C, 64), {}),
        "ndps2c": ((SP, 8), {}), "cdist": ((C, C[::-1].copy()), {}),
        "mcep": ((SP, 8, 0.42, 2), {}),
        "smcep": ((SP, 8), dict(alpha=0.42, theta=0.1, n_iter=2)),
        "mgc2mgc": ((C, 10), dict(in_alpha=0.42, out_gamma=-0.5)),
        "mgc2sp": ((C, 64), dict(alpha=0.42)),
        "freqt2": ((C, 10), dict(alpha=0.1, theta=0.2)),
        "ifreqt2": ((C, 10), dict(alpha=0.1, theta=0.2)),
        "pnorm": ((C, 0.42), {}), "ipnorm": ((C,), {}),
        "mcpf": ((C,), dict(alpha=0.42, beta=0.2)),
        "mlsacheck": ((C,), dict(alpha=0.42, warn_type="ignore")),
        "lpc2lsp": ((A,), {}), "lsp2lpc": ((W,), {}),
        "lsp2sp": ((W, 64), {}),
        "lpccheck": ((A,), dict(warn_type="ignore")),
        "lspcheck": ((W,), dict(warn_type="ignore")),
        "root_pol": ((A,), {}), "pol_root": ((port(F.root_pol, A[0, 0]),),
                                             {}),
        "acr2csm": ((R[..., :4],), {}), "csm2acr": ((CSM,), {}),
        "fbank": ((SP, 8, 16000), {}),
        "ifbank": ((SP[..., :8], 64, 16000), {}),
        "mfcc": ((SP, 6, 8, 16000), {}), "plp": ((SP, 6, 8, 16000), {}),
        "chroma": ((SP, 12, 16000), {}),
        "mdct": ((X, 32), {}), "imdct": ((FR[..., :16],), {}),
        "mdst": ((X, 32), {}), "imdst": ((FR[..., :16],), {}),
        "hilbert": ((X,), {}),
        "griffin": ((np.abs(CX),), dict(frame_length=32, frame_period=16,
                                        fft_length=64, n_iter=3)),
        "decimate": ((X, 3), dict(start=1)),
        "interpolate": ((X, 2), dict(start=1)),
        "delay": ((X, -3), dict(keeplen=True)),
        "entropy": ((P,), dict(out_format="bit")),
        "histogram": ((rng.uniform(size=(2, 50)),),
                      dict(n_bin=5, norm=True, softness=0.05)),
        "snr": ((X, X + 0.01 * rng.standard_normal(X.shape)),
                dict(frame_length=100, full=True)),
        "rmse": ((X, X[::-1].copy()), dict(reduction="none")),
        "f0eval": ((F0, F0B), dict(out_format="f0-rmse-cent")),
        "flux": ((SP,), dict(lag=2, norm=1)),
        "zcross": ((X, 40), dict(norm=True)),
        "grpdelay": ((), dict(b=C[..., :4], a=A, fft_length=64)),
        "phase": ((), dict(b=C[..., :4], a=A, fft_length=64,
                           unwrap=True)),
        "yingram": ((FR,), dict(sample_rate=16000, lag_min=4, n_bin=4)),
        "medfilt": ((SEQ,), dict(filter_length=4, magic_number=0.0)),
        "magic_intpl": ((SEQ,), {}),
        "delta": ((SEQ,), dict(seed=[[-0.5, 0.0, 0.5], [1.0, -2.0, 1.0]])),
        "mlpg": ((rng.standard_normal((2, 20, 9)),), {}),
        "dtw": ((SEQ[:10], Y8), {}),
        "dtw_merge": ((SEQ[:10], Y8, PATH), {}),
        "drc": ((X, 16000), dict(threshold=-30, ratio=4)),
        "excite": ((PITCH,), dict(frame_period=8)),
    }


def to_inputs(torch, args, kw, device, dtype):
    """A case's numpy inputs as tensors on ``device``: real arrays in
    ``dtype``, complex in its complex counterpart, integer arrays int64."""
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128

    def conv(a):
        if not isinstance(a, np.ndarray):
            return a
        a = np.ascontiguousarray(a)
        if np.iscomplexobj(a):
            return torch.as_tensor(a, dtype=cdt, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    return [conv(a) for a in args], {k: conv(v) for k, v in kw.items()}


class _Seen(BaseException):
    """Stops ``fn`` in ``class_path`` once its operator call is seen."""


def class_path(torch, fn, args, kw):
    """``fn``'s operator built afresh (not from the stateless path's cache)
    with the device and dtype the stateless path gives it, called on the
    same inputs: the class path that ``fn`` stands for.  ``fn``'s own call
    records which class and arguments it takes, and stops there, so only
    the class path runs an operator."""
    from diffsptk_tpu_torch import core

    seen = []
    base = core.BaseOp.__dict__["_func"]

    def spy(cls, *inputs, **kwargs):
        seen.append((cls, inputs, dict(kwargs)))
        raise _Seen

    core.BaseOp._func = classmethod(spy)
    try:
        out = fn(*args, **kw)
    except _Seen:
        out = None
    finally:
        core.BaseOp._func = base
    if not seen:               # a static helper (dtw_merge): no operator
        return out
    cls, inputs, kwargs = seen[0]
    kwargs.pop("module", None)
    device, dtype = core._placement(inputs)
    return cls(**kwargs, device=device, dtype=dtype)(*inputs)


def leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [v for o in out for v in leaves(o)]
    return [out] if out is not None else []


def rel_to_max(torch, got, want) -> float:
    """The largest difference of ``got`` from ``want`` over their leaves,
    each relative to the leaf's max|want|: NaN where their NaNs lie apart,
    the NaNs a pair shares left out."""
    err = 0.0
    for g, w in zip(leaves(got), leaves(want), strict=True):
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            return float("nan")
        if w.numel():
            scale = max(float(w.abs().masked_fill(nan, 0).max()), 1e-30)
            diff = float((g - w).abs().masked_fill(nan, 0).max())
            err = max(err, diff / scale)
    return err


def functional_kernel_rows(torch, xs):
    """The five calls of ``functional`` that reach a hand kernel, at their
    shapes (32 x 240 frames of the flagship's signal): (name, function,
    positional inputs, keyword arguments, kernel module's name, launches a
    call)."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import functional as F

    frames = xs.shape[-1] // 80
    sp = power_spectrum(torch, xs)[:, :frames].contiguous()
    fr = pt.Frame(400, 80, device=xs.device, dtype=xs.dtype)(xs)[:, :frames]
    r = F.acorr(fr.contiguous(), 24)
    return [
        ("mcep", F.mcep, (sp, 24, 0.42), dict(n_iter=10), "newton", 10),
        ("smcep", F.smcep, (sp, 24, 0.42), dict(n_iter=10), "newton", 10),
        ("plp", F.plp, (sp, 24, 40, 16000), {}, "solve", 1),
        ("levdur", F.levdur, (r,), {}, "solve", 1),
        ("lpc", F.lpc, (fr.contiguous(), 24), {}, "solve", 1)]


def run_functional(torch, xs, card: str) -> dict:
    """[functional]: each of ``functional``'s 100 functions once on small
    float32 inputs on the card, under set_sync_debug_mode("error") after a
    first call (no host read), each equal to its class path on the same
    inputs within 1e-6 of max|y|; then the five calls that reach a hand
    kernel at their shapes, with the kernel's launches counted (mcep and
    smcep: the Newton kernel 10 a call; PLP-24, levdur and LPC at order 24
    over 7,680 frames: the SPD solve kernel once), each against its class
    path's launches and, within 1e-6 of max|y|, its values.  Returns the
    launch counts."""
    from diffsptk_tpu_torch import functional as F
    from diffsptk_tpu_torch.kernels import newton, solve

    cases = functional_cases(torch)
    errs, synced = {}, []
    with torch.no_grad():
        for name, (args, kw) in cases.items():
            a, k = to_inputs(torch, args, kw, "cuda", torch.float32)
            fn = getattr(F, name)
            fn(*a, **k)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fn(*a, **k)
            except RuntimeError as exc:
                if "synchroniz" not in str(exc):
                    raise
                synced.append(name)
                got = None
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if got is None:
                got = fn(*a, **k)
            check(all(g.is_cuda for g in leaves(got)),
                  f"[functional] {name} left the card")
            errs[name] = rel_to_max(torch, got, class_path(torch, fn, a, k))
        check(not synced, f"[functional] host reads in {synced}")
        bad = {k: v for k, v in errs.items() if not v <= 1e-6}
        check(not bad, f"[functional] against the class path: {bad}")
        mods = {"newton": newton, "solve": solve}
        rows, launches, kerr = [], {}, {}
        for name, fn, a, k, kernel, expected in functional_kernel_rows(
                torch, xs):
            mod = mods[kernel]
            fn(*a, **k)
            torch.cuda.synchronize()
            mod.launches = 0
            y = fn(*a, **k)
            torch.cuda.synchronize()
            launches[name] = mod.launches
            mod.launches = 0
            want = class_path(torch, fn, a, k)
            torch.cuda.synchronize()
            check(launches[name] == expected == mod.launches,
                  f"[functional] {name} launched the {kernel} kernel "
                  f"{launches[name]} times, its class path {mod.launches}, "
                  f"expected {expected}")
            kerr[name] = rel_to_max(torch, y, want)
            ms = float(np.median(cuda_call_ms(torch, lambda: fn(*a, **k),
                                              10, warm=1)))
            rows.append(f"{name} {kernel} x{launches[name]} {ms:.3f} ms, "
                        f"{kerr[name]:.3e} of max|y| from the class path")
        bad = {k: v for k, v in kerr.items() if not v <= 1e-6}
        check(not bad, f"[functional] at the kernels' shapes, against the "
              f"class path: {bad} (bar 1e-6)")
    worst = max(errs, key=errs.get)
    print(f"[functional] {len(errs) - 1} functions (and iwht, another "
          f"name of wht) on the card, float32, each against its class path: "
          f"max {errs[worst]:.3e} of max|y| ({worst}; bar 1e-6), no host "
          f"read; at their shapes (32 x 240 "
          f"frames; kernel, launches a call as the class path's, median of "
          f"10 calls, distance from the class path, bar 1e-6): "
          + ", ".join(rows) + f" | {card}", flush=True)
    return launches


def run_io(torch, xs, params: dict, card: str) -> None:
    """[io]: a 16-bit wav written and read back in a temporary directory
    (within 1/32768); the GMM's parameters through an npz checkpoint
    (exact); ``Throughput`` of the flagship call beside its CUDA-event
    median; ``trace`` of one flagship call (a non-empty chrome trace);
    ``nrand_like`` and ``rand_like`` of the flagship's input drawn on the
    card (one threefry launch each) against the same draws on the host:
    uniform and normals bit for bit (as [K8])."""
    import os
    import tempfile

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import threefry
    from diffsptk_tpu_torch.utils import checkpoint, prng
    from diffsptk_tpu_torch.utils.profiling import Throughput, trace

    key = prng.PRNGKey(5)
    threefry.launches = 0
    noise = pt.nrand_like(xs, key=key), pt.rand_like(xs, key=key, a=-1, b=2)
    draws = threefry.launches
    host = (pt.nrand_like(xs.cpu(), key=key),
            pt.rand_like(xs.cpu(), key=key, a=-1, b=2))
    rel_n = float(((noise[0].cpu() - host[0]).abs() / host[0].abs()).max())
    same_u = torch.equal(noise[1].cpu(), host[1])
    same_n = torch.equal(noise[0].cpu(), host[0])
    check(draws == 2 and all(v.is_cuda for v in noise) and same_u
          and same_n,
          f"[io] signals on the card: {draws} threefry launches (expected "
          f"2), uniform {'equal' if same_u else 'differs'}, normals "
          f"{'equal' if same_n else 'differ'} ({rel_n:.3e} relative)")

    voc = pt.MelCepstralVocoder(cascade="fused", device="cuda",
                                dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "x.wav")
        pt.write(wav, xs[0], 16000)
        y, sr = pt.read(wav, device="cuda", dtype=torch.float32)
        err_wav = float((y - xs[0]).abs().max())
        check(sr == 16000 and err_wav <= 1 / 32768,
              f"[io] the wav round trip: {err_wav:.3e} (bar 1/32768)")
        path = os.path.join(d, "gmm.npz")
        checkpoint.save(path, params)
        back = checkpoint.load(path, {k: torch.zeros_like(v)
                                      for k, v in params.items()})
        check(all(torch.equal(back[k], params[k]) for k in params),
              "[io] the checkpoint did not round-trip exactly")
        with torch.no_grad():
            meter = Throughput(voc.analysis_synthesis, warmup=3, iters=20)
            rate = meter.measure(xs, n_samples=xs.numel())
            event_ms = float(np.median(cuda_call_ms(
                torch, lambda: voc.analysis_synthesis(xs), 20)))
            tdir = os.path.join(d, "trace")
            with trace(tdir):
                voc.analysis_synthesis(xs)
        size = os.path.getsize(os.path.join(tdir, "trace.json"))
        check(size > 0, "[io] the trace is empty")
    print(f"[io] wav round trip {err_wav:.3e} (bar 1/32768); checkpoint of "
          f"the GMM ({', '.join(f'{k} {tuple(v.shape)}' for k, v in params.items())}) "
          f"exact; Throughput of the flagship call {rate:.1f} samples/s "
          f"({meter.last_seconds_per_call * 1e3:.3f} ms a call, host clock), "
          f"CUDA-event median {event_ms:.3f} ms ({xs.numel() / event_ms * 1e3:.1f} "
          f"samples/s); trace {size} bytes; nrand_like and rand_like of "
          f"{tuple(xs.shape)} drawn on the card ({draws} threefry launches): "
          f"uniform and normals equal to the host's draws bit for bit "
          f"| {card}", flush=True)


# [sharded]'s bars: each sharded class on the card against the port's
# one-rank class on the same card inputs (and [sharded-multi]'s unshard
# against one card), relative to the largest value (rel_to_max): ten
# times the larger CPU float32 reading of the same pairs, one rank and N
# ranks, or ten times float32's epsilon where the readings are smaller
# (`python3 tools/torch_sharded_bars.py 2 --multi 2` and `4 --multi 4`:
# gloo ranks on the CPU).  Where one rank holds everything, most pairs
# compute the same operations and read 0.  The GMM's, on [learners]'
# 76,800 frames (`python3 tools/torch_sharded_bars.py 2 --multi 4
# --gmm-only`): its float32 fit (w, mu, sigma, ll) on 4 ranks read 7.0e-5
# from one rank, and its float64 fit 3.8e-13 (gmm64, [sharded-multi]).
SHARDED_BARS = {
    "vocoder": 1.7e-2, "vocoder-analyze": 1.2e-6, "mlsa-per-stage": 2.5e-5,
    "mlsa-bulk": 2.5e-5, "world": 4.4e-3, "world-analyze": 7.5e-6,
    "world-synthesize": 2.2e-5, "poledf": 9.4e-5, "pqmf": 1.2e-6,
    "ipqmf": 1.2e-6, "mdct": 1.2e-6, "imdct": 4.2e-6, "cqt": 1.2e-6,
    "icqt": 1.2e-6, "gmm": 7.0e-4, "gmm64": 3.8e-12,
}
# launches a sharded call makes of each kernel on the card (float32), and
# the host reads it may make (the GMM's: one a step)
SHARDED_ITERS = {"gmm": 3}
SHARDED_LAUNCHES = {
    "vocoder": {"newton": 10, "mcep_residual": 10},
    "vocoder-analyze": {"newton": 10, "mcep_residual": 10},
    "world": {"gather": 4, "ola": 1, "threefry": 2},
    "world-analyze": {"gather": 4, "threefry": 1},
    "world-synthesize": {"ola": 1, "threefry": 1},
}
SHARDED_READS = {"gmm": SHARDED_ITERS["gmm"]}


def sharded_joint(torch, data):
    """[learners]' centred joint vectors (voice conversion's), which the
    data-parallel GMM fits."""
    joint = torch.cat([data["mc_x"], data["mc_y"]], -1)
    return (joint - joint.mean(0)).contiguous()


def sharded_inputs(torch, xw, xb, joint, device, dtype) -> dict:
    """[sharded]'s global inputs: speech rows of the flagship's length
    (xw), [battery]'s rows (xb), the GMM's rows (joint), and what the
    one-rank classes make of them for the synthesis and inverse cases:
    the vocoder's mel-cepstra, WORLD's even frames, the LPC chain's
    coefficients and residual, the PQMF subbands, the MDCT and the CQT
    frames."""
    import diffsptk_tpu_torch as pt

    kw = dict(device=device, dtype=dtype)
    T = xb.shape[-1]
    with torch.no_grad():
        f0, ap, sp = pt.WorldVocoder(80, 16000, 1024, ap_algorithm="tandem",
                                     **kw).analyze(xw, even_frames=True)
        a, e, _ = lpc_chain(torch, 24, device, dtype)[0](xw)
        return {
            "xw": xw, "xb": xb, "joint": joint,
            "mc": pt.MelCepstralVocoder(cascade="fused", **kw).analyze(xw),
            "f0": f0, "ap": ap, "sp": sp, "a": a, "e": e,
            "sub": pt.PQMF(4, 47, **kw)(xb),
            "mdct": pt.MDCT(256, **kw)(xb),
            "cq": pt.CQT(64, 16000, n_bin=24, **kw)(xb)[..., :T // 64, :]}


# each input's (time dimension, trailing entries on the last time rank);
# every one is cut over the batch axis along its first dimension
SHARDED_LAYOUT = {"xw": (-1, 0), "xb": (-1, 0), "joint": (None, 0),
                  "mc": (-2, 0), "f0": (-1, 0), "ap": (-2, 0),
                  "sp": (-2, 0), "a": (-2, 0), "e": (-1, 0), "sub": (-1, 0),
                  "mdct": (-2, 1), "cq": (-2, 0)}
# each case's output's time dimension (None: the GMM's parameters, the
# same on every rank)
SHARDED_OUT_DIM = {"vocoder-analyze": -2, "world-analyze": (-1, -2, -2),
                   "mdct": -2, "cqt": -2, "gmm": None, "gmm64": None}


def sharded_cases(torch, mesh, inp: dict, device, dtype,
                  rows_axis: str = "dp") -> dict:
    """[sharded]'s pairs: name -> (the sharded call, the one-rank call),
    each a function of no arguments, on ``inp``: the rank's blocks of
    ``sharded_inputs`` (the whole inputs where one rank holds
    everything).  The GMM's rows are spread over ``rows_axis``."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.parallel import (
        ShardedAllPoleDigitalFilter,
        ShardedMelCepstralVocoder,
        ShardedWorldVocoder,
    )
    from diffsptk_tpu_torch.parallel.filterbanks import (
        ShardedCQT,
        ShardedICQT,
        ShardedIMDCT,
        ShardedIPQMF,
        ShardedMDCT,
        ShardedPQMF,
    )

    kw = dict(device=device, dtype=dtype)
    xw, xb, joint = inp["xw"], inp["xb"], inp["joint"]
    T = xb.shape[-1]
    voc = ShardedMelCepstralVocoder(mesh, **kw)
    # the one-rank cascade in the sharded one's form, the folded matmul
    # plans (the cascade kernel computes it as a direct FIR)
    voc1 = pt.MelCepstralVocoder(cascade="folded", **kw)
    wv = ShardedWorldVocoder(mesh, 80, 16000, 1024, **kw)
    wv1 = pt.WorldVocoder(80, 16000, 1024, ap_algorithm="tandem", **kw)
    poledf = ShardedAllPoleDigitalFilter(mesh, 24, 80)
    poledf1 = pt.AllPoleDigitalFilter(24, 80, **kw)
    # each pair's operators built once: a call copies nothing to the card
    fb = {"pqmf": (ShardedPQMF(mesh, 4, 47, **kw), pt.PQMF(4, 47, **kw)),
          "ipqmf": (ShardedIPQMF(mesh, 4, 47, **kw), pt.IPQMF(4, 47, **kw)),
          "mdct": (ShardedMDCT(mesh, 256, **kw), pt.MDCT(256, **kw)),
          "imdct": (ShardedIMDCT(mesh, 256, **kw), pt.IMDCT(256, **kw)),
          "cqt": (ShardedCQT(mesh, 64, 16000, n_bin=24, **kw),
                  pt.CQT(64, 16000, n_bin=24, **kw)),
          "icqt": (ShardedICQT(mesh, 64, 16000, n_bin=24, **kw),
                   pt.ICQT(64, 16000, n_bin=24, **kw))}
    return {
        "vocoder": (lambda: voc.analysis_synthesis(xw),
                    lambda: voc1.analysis_synthesis(xw)),
        "vocoder-analyze": (lambda: voc.analyze(xw),
                            lambda: voc1.analyze(xw)),
        "mlsa-per-stage": (lambda: voc.synthesize(xw, inp["mc"]),
                           lambda: voc1.synthesize(xw, inp["mc"])),
        "mlsa-bulk": (lambda: voc.synthesize(xw, inp["mc"], halo="bulk"),
                      lambda: voc1.synthesize(xw, inp["mc"])),
        "world": (lambda: wv.analysis_synthesis(xw),
                  lambda: wv1.synthesize(*wv1.analyze(
                      xw, even_frames=True))),
        "world-analyze": (lambda: wv.analyze(xw),
                          lambda: wv1.analyze(xw, even_frames=True)),
        "world-synthesize": (
            lambda: wv.synthesize(inp["f0"], inp["ap"], inp["sp"]),
            lambda: wv1.synthesize(inp["f0"], inp["ap"], inp["sp"])),
        "poledf": (lambda: poledf(inp["e"], inp["a"]),
                   lambda: poledf1(inp["e"], inp["a"])),
        "pqmf": (lambda: fb["pqmf"][0](xb), lambda: fb["pqmf"][1](xb)),
        "ipqmf": (lambda: fb["ipqmf"][0](inp["sub"]),
                  lambda: fb["ipqmf"][1](inp["sub"])),
        "mdct": (lambda: fb["mdct"][0](xb), lambda: fb["mdct"][1](xb)),
        "imdct": (lambda: fb["imdct"][0](inp["mdct"]),
                  lambda: fb["imdct"][1](inp["mdct"])),
        "cqt": (lambda: fb["cqt"][0](xb),
                lambda: fb["cqt"][1](xb)[..., :T // 64, :]),
        "icqt": (lambda: fb["icqt"][0](inp["cq"]),
                 lambda: fb["icqt"][1](inp["cq"], out_length=T)),
        "gmm": sharded_gmm(torch, mesh, joint, device, dtype, rows_axis),
    }


def sharded_gmm(torch, mesh, joint, device, dtype, rows_axis: str = "dp"):
    """The data-parallel GMM's pair: (the fit of ``DataParallelGMM`` on
    this rank's rows ``joint``, the one-rank GMM's fit on them), each a
    function of no arguments returning (w, mu, sigma, ll), both from the
    float32 model's initial parameters, in ``dtype``."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.parallel import DataParallelGMM

    kw = dict(n_iter=SHARDED_ITERS["gmm"], eps=0, var_type="full",
              block_size=[25, 25], device=device)
    start = pt.GMM(49, 32, dtype=torch.float32, **kw)
    init = tuple(p.to(dtype) for p in (start.w, start.mu, start.sigma))
    x = joint.to(dtype)

    def fit(model):
        def run():
            model.set_params(init)
            (w, mu, sigma), ll = model(x)
            return w, mu, sigma, ll
        return run

    return (fit(DataParallelGMM(mesh, 49, 32, batch_axis_name=rows_axis,
                                dtype=dtype, **kw)),
            fit(pt.GMM(49, 32, dtype=dtype, **kw)))


def sharded_counters():
    from diffsptk_tpu_torch.kernels import (
        gather,
        mcep_residual,
        newton,
        ola,
        threefry,
    )
    return {"newton": newton, "mcep_residual": mcep_residual,
            "gather": gather, "ola": ola, "threefry": threefry}


def run_sharded(torch, xw, xb, joint, card: str) -> dict:
    """[sharded]: the sharded classes (parallel/) through an NCCL process
    group of world size 1 and a (1, 1) CUDA mesh, at full width in
    float32: the mel-cepstral vocoder on the flagship's 32 x 19,200 (its
    round trip, its analysis, its synthesis with both halos), WORLD with
    TANDEM on 32 x 19,200 (round trip, analysis, synthesis), the all-pole
    filter at M = 24, P = 80 on the same, the six filterbanks on
    [battery]'s 8 x 76,800 and the data-parallel GMM on [learners]' 76,800
    joint vectors (SHARDED_ITERS EM steps).  Each against the port's
    one-rank class on the card (SHARDED_BARS), with each kernel's
    launches a call (SHARDED_LAUNCHES) and the host reads
    (``HostReads``: none but the GMM's, one a step); the vocoder's round
    trip also against a float64 CPU run of row 0 (1e-2 of max|y|); the
    median ms a call and, for the round trips, the filter, the battery
    and the GMM, the busy share.  Returns each kernel's launches in the
    vocoder's and WORLD's round trips."""
    import datetime

    import torch.distributed as dist

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.parallel import ShardedMelCepstralVocoder
    from diffsptk_tpu_torch.parallel import make_mesh

    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1))
        pairs = sharded_cases(torch, mesh, sharded_inputs(
            torch, xw, xb, joint, "cuda", torch.float32), "cuda",
            torch.float32)
        counters = sharded_counters()
        busy_of = ("vocoder", "world", "poledf", "cqt", "gmm")
        seen = {}
        with torch.no_grad():
            for name, (fn, ref) in pairs.items():
                fn()                                     # plans, caches
                torch.cuda.synchronize()
                for mod in counters.values():
                    mod.launches = 0
                _, got, reads = timed_reads(torch, fn, "cuda")
                launches = {k: mod.launches for k, mod in counters.items()
                            if mod.launches}
                want = ref()
                err = rel_to_max(torch, got, want)
                check(err <= SHARDED_BARS[name],
                      f"[sharded] {name}: {err:.3e} from the one-rank "
                      f"class (bar {SHARDED_BARS[name]})")
                expected = SHARDED_LAUNCHES.get(name, {})
                check(launches == expected,
                      f"[sharded] {name}: launches {launches}, expected "
                      f"{expected}")
                allowed = SHARDED_READS.get(name, 0)
                check(reads.count == allowed,
                      f"[sharded] {name}: {reads.count} host reads "
                      f"(allowed {allowed}) at {reads.where}")
                calls = cuda_call_ms(torch, fn, 3 if name == "gmm" else 10,
                                     warm=1)
                med = float(np.median(calls))
                busy = ""
                if name in busy_of:
                    b, _, _, _, wall = profile_chain(torch, fn, calls=2)
                    busy = ", " + busy_share(b, wall)
                seen[name] = launches
                print(f"[sharded] {name}: {err:.3e} of max from the "
                      f"one-rank class (bar {SHARDED_BARS[name]}), "
                      f"launches {launches or 'none'}, host reads "
                      f"{reads.count} (allowed {allowed}), median "
                      f"{med:.3f} ms a call{busy} | {card}", flush=True)
            # the flagship's round trip against float64 on the CPU: row 0,
            # all of its 19,200 samples
            x1 = xw[:1]
            voc = ShardedMelCepstralVocoder(mesh, device="cuda",
                                            dtype=torch.float32)
            y1 = voc.analysis_synthesis(x1).double().cpu()
            y64 = pt.MelCepstralVocoder(cascade="folded", device="cpu",
                                        dtype=torch.float64
                                        ).analysis_synthesis(
                                            x1.double().cpu())
            err64 = float((y1 - y64).abs().max() / y64.abs().max())
            check(err64 <= 1e-2,
                  f"[sharded] vocoder row 0: {err64:.3e} of max|y| from "
                  f"float64 on the CPU (bar 1e-2)")
        print(f"[sharded] NCCL world size 1, mesh (1, 1), float32, "
              f"{len(pairs)} pairs within their bars; the vocoder's row 0 "
              f"against float64 on the CPU {err64:.3e} of max|y| (bar "
              f"1e-2) | {card}", flush=True)
    finally:
        dist.destroy_process_group()
    return {"vocoder": seen["vocoder"], "world": seen["world"]}


# [sharded-multi]'s classes: all but the synthesis-only and inverse ones
# [sharded] holds already, and the CQT, whose halo at [battery]'s
# configuration (295,168 samples) exceeds a block of 76,800 / n
SHARDED_MULTI = ("vocoder", "world", "poledf", "pqmf", "mdct", "icqt",
                 "gmm")


def sharded_multi_rank(rank: int, world: int, device: str, inputs: dict,
                       names: tuple) -> dict:
    """One rank of [sharded-multi] (``spawn_ranks``' worker): its blocks
    of ``inputs`` (numpy, ``sharded_inputs``'s) through the sharded classes
    ``names`` on a (1, world) mesh, the GMM's rows spread over its time
    axis (and its fit again in float64, ``gmm64``), gathered back with
    ``unshard``: the results (numpy)."""
    import torch

    from diffsptk_tpu_torch.parallel import make_mesh, shard, unshard

    dev = torch.device(device, rank) if device == "cuda" else "cpu"
    if device == "cuda":
        # full fp32, as main() sets it for the one-card run
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1, world), device_type=device)
    local = {}
    for k, v in inputs.items():
        t = torch.as_tensor(v, device=dev)
        time_dim, tail = SHARDED_LAYOUT[k]
        local[k] = (shard(t, mesh, time_dim=None, batch_dim=0,
                          batch_axis_name="tp") if k == "joint"
                    else shard(t, mesh, time_dim=time_dim, tail=tail))
    pairs = sharded_cases(torch, mesh, local, dev, torch.float32,
                          rows_axis="tp")
    if "gmm" in names:
        pairs["gmm64"] = sharded_gmm(torch, mesh, local["joint"], dev,
                                     torch.float64, rows_axis="tp")
    res = {}
    with torch.no_grad():
        for name in names + ("gmm64",) * ("gmm" in names):
            y = pairs[name][0]()
            dim = SHARDED_OUT_DIM.get(name, -1)
            res[name] = ([v.cpu().numpy() for v in y] if dim is None
                         else unshard(y, mesh, time_dim=dim
                                      ).cpu().numpy())
    return res


def gmm_leaves(torch, got, want) -> list:
    """Each leaf of two GMM fits (w, mu, sigma, ll) apart, relative to
    the leaf's max|want| (``rel_to_max``), on the CPU in float64."""
    return [rel_to_max(torch, torch.as_tensor(a).cpu().double(),
                       torch.as_tensor(b).cpu().double())
            for a, b in zip(got, want)]


def run_sharded_multi(torch, xw, xb, joint, card: str, device="cuda",
                      world: int | None = None,
                      names: tuple = SHARDED_MULTI) -> dict:
    """[sharded-multi]: with two cards or more, one NCCL rank a card and a
    (1, n) mesh; each class's ``unshard``ed output against the one-card
    output of the same class on the same inputs at [sharded]'s bars.
    With one card it says that it did not run (NCCL takes one rank a
    card).  ``device="cpu"`` and ``world`` run it on gloo ranks instead
    (tests)."""
    import datetime

    import torch.distributed as dist

    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.ranks import spawn_ranks

    n = torch.cuda.device_count() if world is None else world
    if n < 2:
        print(f"[sharded-multi] not run: {n} card present, and NCCL takes "
              f"one rank a card | {card}", flush=True)
        return {}
    backend = "nccl" if device == "cuda" else "gloo"
    inputs = {k: v.cpu().numpy() for k, v in sharded_inputs(
        torch, xw, xb, joint, device, torch.float32).items()
        if k in ("xw", "xb", "joint", "a", "e", "cq")}
    got = spawn_ranks(sharded_multi_rank, n, device, inputs, names)
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        inp = {k: torch.as_tensor(v, device=device)
               for k, v in inputs.items()}
        mesh = make_mesh((1, 1), device_type=device)
        pairs = sharded_cases(torch, mesh, inp, device, torch.float32)
        if "gmm" in names:
            pairs["gmm64"] = sharded_gmm(torch, mesh, inp["joint"], device,
                                         torch.float64)
        errs, gmm = {}, {}
        with torch.no_grad():
            for name in names:
                one = pairs[name][0]()
                if name == "gmm":
                    one64 = pairs["gmm64"][0]()
                    gmm = {"n32-one32": gmm_leaves(torch, got["gmm"], one),
                           "n64-one64": gmm_leaves(torch, got["gmm64"],
                                                   one64),
                           "n32-one64": gmm_leaves(torch, got["gmm"], one64),
                           "one32-one64": gmm_leaves(torch, one, one64)}
                    errs["gmm"] = max(gmm["n32-one32"])
                    errs["gmm64"] = max(gmm["n64-one64"])
                else:
                    errs[name] = rel_to_max(torch, torch.as_tensor(
                        got[name]), one.cpu())
    finally:
        dist.destroy_process_group()
    print(f"[sharded-multi] {n} ranks, mesh (1, {n}), each class's "
          f"unshard against one card (bar): "
          + "; ".join(f"{k} {v:.3e} ({SHARDED_BARS[k]})"
                      for k, v in errs.items()) + f" | {card}", flush=True)
    if gmm:
        print(f"[sharded-multi] the GMM's w, mu, sigma, ll relative to "
              f"their max, {n} ranks (n) and one (one), float32 (32) and "
              f"float64 (64) fits from one start: "
              + "; ".join(f"{k} " + ", ".join(f"{v:.3e}" for v in vals)
                          for k, vals in gmm.items()) + f" | {card}",
              flush=True)
    for name, err in errs.items():
        check(err <= SHARDED_BARS[name],
              f"[sharded-multi] {name}: {err:.3e} from one card (bar "
              f"{SHARDED_BARS[name]})")
    return errs


# [sharded-train]: the JAX package's multi-chip training step
# (diffsptk_tpu_torch/parallel/train.py) at the flagship's full width
SHARDED_TRAIN_B, SHARDED_TRAIN_T = 32, 19200
SHARDED_TRAIN_WARM, SHARDED_TRAIN_STEPS = 3, 10
# launches a step: WORLD's round trip (no other term reaches a kernel, and
# WORLD has no parameter, so no backward)
SHARDED_TRAIN_LAUNCHES = SHARDED_LAUNCHES["world"]
# ten times the CPU float32 step's distance from float64, relative to
# max|want| (`python3 tools/torch_sharded_train_bars.py`: rows 0-1 of the
# step's input with stable_lpc's coefficients, the float64 WORLD replaying
# the float32 noise, read loss 6.173e-8, window 1.772e-7, mc 7.914e-7, lpc
# 7.909e-7 and the WORLD term 8.191e-4); the bars of the kernel path
# against the twins, of rows 0-1 against float64, and of n cards against
# one.  The WORLD term has a bar of its own: it is about 1e-4 of the
# loss, so the loss's bar alone would pass a fault in its kernels
SHARDED_TRAIN_BARS = {"loss": 1.2e-6, "window": 1.8e-6, "mc": 7.9e-6,
                      "lpc": 7.9e-6, "world": 8.2e-3}


def stable_lpc(B: int, N: int, order: int = 24, seed: int = 5
               ) -> np.ndarray:
    """LPC frames [1, a_1 .. a_M] (B, N, M+1) with sum |a_k| <= 0.3, so
    the all-pole filter is stable at every interpolated sample: the lpc
    of [sharded-train]'s checks (the dryrun's [1, 0, ...] makes the
    filter the identity and lpc's gradient zero)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.0, 1.0, (B, N, order)) * (0.3 / order)
    return np.concatenate([np.ones((B, N, 1)), a], -1)


def train_pytree(step, inputs: dict, stable: bool) -> dict:
    """The JAX step's params pytree (numpy) for ``inputs``
    (``dryrun_inputs``): the STFT's initial window, the dryrun's mc, and
    its lpc or, with ``stable``, ``stable_lpc``'s."""
    lpc = inputs["lpc"]
    if stable:
        lpc = stable_lpc(*lpc.shape[:2]).astype(lpc.dtype)
    return {"window": {"window": step.window_init()}, "mc": inputs["mc"],
            "lpc": lpc}


def train_grads(step, params: dict, x, target) -> dict:
    """One backward of the step from the pytree ``params``: the loss and
    its WORLD term, each summed over the mesh, and the gradients of
    window, mc and lpc (this rank's blocks of mc and lpc).  WORLD is held
    apart: it is the one term that reaches a kernel, about 1e-4 of the
    loss, and no gradient passes through it."""
    from diffsptk_tpu_torch.parallel.mesh import mesh_sum

    p = step.params_from_jax(params)
    loss, terms, g = step.loss_and_grads(p, x, target)
    return {"loss": mesh_sum(loss, step.mesh),
            "world": mesh_sum(terms["world"], step.mesh),
            "window": g["window"]["window"], "mc": g["mc"], "lpc": g["lpc"]}


def train_errs(torch, got: dict, want: dict, scale: float = 1.0) -> dict:
    """Each of ``SHARDED_TRAIN_BARS``' leaves of ``got`` against
    ``scale`` times ``want``'s (``rel_to_max``, on the CPU in float64)."""
    return {k: rel_to_max(torch, torch.as_tensor(got[k]).cpu().double(),
                          scale * torch.as_tensor(want[k]).cpu().double())
            for k in SHARDED_TRAIN_BARS if k in want}


def train_term_split(torch, step, p, x, target, calls: int = 5) -> dict:
    """CUDA-event ms of each loss term's forward and of its backward
    (medians of ``calls`` after one warm call), then of the window's
    reduction and the SGD update (``DryrunStep.update``): {name:
    (forward, backward)}."""
    from diffsptk_tpu_torch.parallel.train import TERMS

    def timed(fn):
        ms = []
        for _ in range(calls + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            value = fn()
            ev[1].record()
            if isinstance(value, torch.Tensor) and value.requires_grad:
                value.backward()
            ev[2].record()
            torch.cuda.synchronize()
            ms.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        return tuple(float(np.median([m[i] for m in ms[1:]]))
                     for i in (0, 1))

    split = {name: timed(lambda name=name: step.term(name, p, x, target))
             for name in TERMS}

    # train_step's, on the gradients at hand
    split["reduce+update"] = timed(lambda: step.update(p))
    for t in (p["window"]["window"], p["mc"], p["lpc"]):
        t.grad = None
    return split


def run_sharded_train(torch, card: str) -> None:
    """[sharded-train]: ``DryrunStep`` (the JAX package's multi-chip
    training step) through an NCCL process group of world size 1 on a
    (1, 1) mesh at B = 32, T = 19,200, float32: SHARDED_TRAIN_WARM steps,
    then SHARDED_TRAIN_STEPS timed ones (CUDA events; median and p90 ms a
    step), the busy share, peak memory, each kernel's launches a step
    (SHARDED_TRAIN_LAUNCHES) and the host reads (none); the split by term,
    forward and backward; then, from stable_lpc's coefficients, the kernel
    path against ``twins()`` (the loss, its WORLD term, the one that
    reaches the kernels, and the gradients of window, mc and lpc) and
    rows 0-1 of mc's and lpc's gradients against a float64 CPU
    step on those rows, times 2/32 (every term's count is proportional to
    B), all within SHARDED_TRAIN_BARS.  Then [sharded-train]'s n-card
    check (``run_sharded_train_multi``) and ``dryrun_multichip(1)``."""
    import datetime

    import torch.distributed as dist

    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.entry import dryrun_multichip
    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.train import DryrunStep, dryrun_inputs

    B, T, steps = SHARDED_TRAIN_B, SHARDED_TRAIN_T, SHARDED_TRAIN_STEPS
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1))
        step = DryrunStep(mesh, device="cuda", dtype=torch.float32)
        inputs = dryrun_inputs(B, T, np.float32)
        x, target = step.blocks(inputs)
        p = step.params_from_jax(train_pytree(step, inputs, False))
        for _ in range(SHARDED_TRAIN_WARM):
            _, p = step.train_step(p, x, target)
        counters = sharded_counters()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(steps)]
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in counters.values():
            mod.launches = 0
        with HostReads(torch, "cuda") as reads:
            for start, stop in events:
                start.record()
                loss, p = step.train_step(p, x, target)
                stop.record()
                losses.append(loss)
        torch.cuda.synchronize()
        totals = {k: mod.launches for k, mod in counters.items()
                  if mod.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = [a.elapsed_time(b) for a, b in events]
        losses = torch.stack(losses).cpu()
        expected = {k: steps * v for k, v in SHARDED_TRAIN_LAUNCHES.items()}
        check(bool(torch.isfinite(losses).all()),
              f"[sharded-train] losses not finite: {losses.tolist()}")
        check(totals == expected,
              f"[sharded-train] launches in {steps} steps {totals}, "
              f"expected {expected}")
        check(reads.count == 0,
              f"[sharded-train] {reads.count} host reads in {steps} steps "
              f"at {reads.where}")
        busy, _, nfun, _, wall = profile_chain(
            torch, lambda: step.train_step(p, x, target), calls=2)
        print(f"[sharded-train] NCCL world size 1, mesh (1, 1), B={B} "
              f"T={T} float32: median {np.median(ms):.3f} ms a step, p90 "
              f"{np.percentile(ms, 90):.3f} ({steps} steps after "
              f"{SHARDED_TRAIN_WARM}); {B * T / np.median(ms) * 1e3:.0f} "
              f"samples/s; loss {float(losses[0]):.6f} -> "
              f"{float(losses[-1]):.6f}; {busy_share(busy, wall)}, "
              f"{nfun:.0f} device functions a step; peak memory "
              f"{peak:.2f} GiB; launches a step "
              f"{ {k: v // steps for k, v in totals.items()} } (expected "
              f"{SHARDED_TRAIN_LAUNCHES}); host reads a step "
              f"{reads.count / steps:g} (allowed 0) | {card}", flush=True)
        split = train_term_split(torch, step, p, x, target)
        print("[sharded-train] split, CUDA-event ms (forward, backward; "
              "medians of 5): " + "; ".join(
                  f"{k} {f:.3f}, {b:.3f}" for k, (f, b) in split.items())
              + f"; sum {sum(f + b for f, b in split.values()):.3f} | "
              f"{card}", flush=True)
        # the checks, from stable_lpc's coefficients (lpc's gradient is
        # zero at the dryrun's [1, 0, ...])
        pk = train_pytree(step, inputs, True)
        got = train_grads(step, pk, x, target)
        with twins():
            want = train_grads(step, pk, x, target)
        twin = train_errs(torch, got, want)
        cpu = DryrunStep(mesh, device="cpu", dtype=torch.float64)
        rows = {k: v[:2].astype(np.float64) for k, v in inputs.items()}
        pk64 = {"window": {k: v.astype(np.float64)
                           for k, v in pk["window"].items()},
                "mc": rows["mc"], "lpc": pk["lpc"][:2].astype(np.float64)}
        ref = train_grads(cpu, pk64, *cpu.blocks(rows))
        row_err = train_errs(torch, {k: got[k][:2] for k in ("mc", "lpc")},
                             {k: ref[k] for k in ("mc", "lpc")}, 2 / B)
        print("[sharded-train] from stable_lpc's coefficients: kernel path "
              "against twins() (bar): " + "; ".join(
                  f"{k} {v:.3e} ({SHARDED_TRAIN_BARS[k]})"
                  for k, v in twin.items())
              + "; rows 0-1 against a float64 CPU step on them, times 2/"
              f"{B} (bar): " + "; ".join(
                  f"{k} {v:.3e} ({SHARDED_TRAIN_BARS[k]})"
                  for k, v in row_err.items()) + f" | {card}", flush=True)
        for tag, errs in (("twins()", twin), ("float64 rows 0-1", row_err)):
            for k, v in errs.items():
                check(v <= SHARDED_TRAIN_BARS[k],
                      f"[sharded-train] {k} {v:.3e} from {tag} (bar "
                      f"{SHARDED_TRAIN_BARS[k]})")
    finally:
        dist.destroy_process_group()
    run_sharded_train_multi(torch, card)
    loss = dryrun_multichip(1)
    check(np.isfinite(loss), f"[sharded-train] dryrun_multichip(1): {loss}")
    print(f"[sharded-train] dryrun_multichip(1) ran on the card, loss "
          f"{loss:.6f} (its line above) | {card}", flush=True)


def sharded_train_rank(rank: int, world: int, device: str, dp: int, tp: int,
                       inputs: dict, params: dict) -> dict:
    """One rank of [sharded-train]'s n-card check (``spawn_ranks``'
    worker): its blocks of the global ``inputs`` and ``params`` (numpy)
    through ``DryrunStep`` on the (dp, tp) mesh: one backward
    (``train_grads``) gathered whole, and the median ms of 3
    ``train_step``s after one."""
    import torch

    from diffsptk_tpu_torch.parallel import make_mesh, unshard
    from diffsptk_tpu_torch.parallel.train import DryrunStep

    mesh = make_mesh((dp, tp), device_type=device)
    step = DryrunStep(mesh, device=device, dtype=torch.float32)
    x, target = step.blocks(inputs)
    g = train_grads(step, params, x, target)
    res = {"loss": float(g["loss"]), "world": float(g["world"]),
           "window": g["window"].cpu().numpy(),
           **{k: unshard(g[k], mesh, time_dim=-2).cpu().numpy()
              for k in ("mc", "lpc")}}
    p = step.params_from_jax(params)
    ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        loss, p = step.train_step(p, x, target)
        float(loss)                  # the step's end on every rank
        ms.append((time.perf_counter() - t0) * 1e3)
    res["ms"] = float(np.median(ms[1:]))
    return res


def run_sharded_train_multi(torch, card: str, world: int | None = None
                            ) -> dict:
    """[sharded-train] across cards: with two cards or more (``world`` of
    them, all by default), one NCCL rank a card on the dryrun's (dp, tp)
    mesh, each rank holding a block of the flagship's 32 x 19,200 of a
    (32 dp) x (19,200 tp) input, from stable_lpc's coefficients: the loss,
    its WORLD term and the gradients against one card's step on the same
    global input (SHARDED_TRAIN_BARS), and ms a step on n cards and on
    one (host clock, the step's end read on every rank).  With one card it
    says that it did not run."""
    import datetime

    import torch.distributed as dist

    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.ranks import spawn_ranks
    from diffsptk_tpu_torch.parallel.train import (DryrunStep, dryrun_inputs,
                                                   dryrun_shape)

    n = torch.cuda.device_count() if world is None else world
    if n < 2:
        print(f"[sharded-train] n cards: not run, {n} card present, and "
              f"NCCL takes one rank a card | {card}", flush=True)
        return {}
    dp, tp, _, _ = dryrun_shape(n)
    rows, samples = SHARDED_TRAIN_B, SHARDED_TRAIN_T
    B, T = rows * dp, samples * tp
    inputs = dryrun_inputs(B, T, np.float32)
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        one = DryrunStep(make_mesh((1, 1)), device="cuda",
                         dtype=torch.float32)
        params = train_pytree(one, inputs, True)
        x, target = one.blocks(inputs)
        want = train_grads(one, params, x, target)
        p = one.params_from_jax(params)
        ms1 = []
        for _ in range(4):
            t0 = time.perf_counter()
            loss, p = one.train_step(p, x, target)
            float(loss)
            ms1.append((time.perf_counter() - t0) * 1e3)
        want = {k: v.detach().cpu() for k, v in want.items()}
        del one, x, target, p
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    got = spawn_ranks(sharded_train_rank, dp * tp, "cuda", dp, tp, inputs,
                      params)
    errs = train_errs(torch, got, want)
    print(f"[sharded-train] {dp * tp} ranks on the mesh ({dp}, {tp}), "
          f"{B} x {T} (each rank {rows} x {samples}), against one card on "
          f"the same input (bar): " + "; ".join(
              f"{k} {v:.3e} ({SHARDED_TRAIN_BARS[k]})"
              for k, v in errs.items())
          + f"; ms a step {got['ms']:.3f} on {dp * tp}, "
          f"{float(np.median(ms1[1:])):.3f} on one | {card}", flush=True)
    for k, v in errs.items():
        check(v <= SHARDED_TRAIN_BARS[k],
              f"[sharded-train] {k}: {v:.3e} from one card (bar "
              f"{SHARDED_TRAIN_BARS[k]})")
    return errs


TRAIN_STEPS = 40      # [train-pitch]: steps from the initial parameters
TRAIN_RESUMED = 10    # FCNF0 steps resumed from the bundled checkpoint
TRAIN_WARM = 5        # steps before the timed ones
TRAIN_BATCH = {"fcnf0": 64, "crepe": 128}    # the trainers' defaults
# One step's gradients on the card against the CPU twin's in float64 (the
# same batch), of max|g|: in full fp32 1e-4; in TF32 (FCNF0's precision)
# ten times the reading of 6.23e-2 (tools/torch_train_precision.py, NVIDIA
# H100).  The CPU's own float32 lay 7.3e-4 from its float64 there, so a
# float32 CPU reference cannot hold the card at 1e-4.
TRAIN_GRAD_BAR = 1e-4
TRAIN_TF32_GRAD_BAR = 0.63
TF32_PEAK = 495e12    # H100 SXM dense TF32, flop/s


def train_tool(name: str):
    """A trainer of ``tools/`` (``tools/<name>.py``), loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_steps(torch, step, steps: int, warm: int = TRAIN_WARM):
    """``step(i)`` for i < ``steps``, each returning its loss on the card:
    the first ``warm`` untimed, the rest each between two CUDA events and
    under ``HostReads``.  Returns the losses (on the host, read once at
    the end), the timed steps' ms and the ``HostReads``."""
    losses = [step(i) for i in range(warm)]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(warm, steps)]
    torch.cuda.synchronize()
    with HostReads(torch, losses[0].device) as hr:
        for i, (start, stop) in enumerate(events, start=warm):
            start.record()
            losses.append(step(i))
            stop.record()
    torch.cuda.synchronize()
    ms = [start.elapsed_time(stop) for start, stop in events]
    return torch.stack(losses).cpu().numpy(), ms, hr


def train_line(torch, name: str, losses, ms, hr, batch: int, flops: float,
               peak: float, prof) -> str:
    """One run's numbers: ms a step (median and p90 of the timed steps),
    frames/s at the median, the bound, busy share, peak memory, host
    reads, the losses, and the costliest device functions."""
    busy, top, n_dev, wall = prof
    med = float(np.median(ms))
    bound = flops * batch / (TF32_PEAK if name == "fcnf0" else F32_PEAK) \
        * 1e3
    return (f"median {med:.3f} ms a step (p90 "
            f"{float(np.percentile(ms, 90)):.3f}, {len(ms)} timed steps "
            f"after {TRAIN_WARM}), {batch / med * 1e3:.0f} frames/s; bound "
            f"{bound:.4f} ms ({3 * flops * batch / 3e9:.1f} GFLOP at "
            f"{'TF32' if name == 'fcnf0' else 'fp32'} peak, "
            f"{100 * bound / med:.2f} % reached); "
            f"{busy_share(busy, wall)}, {n_dev:.0f} device functions a "
            f"step; peak memory {peak:.1f} MiB; host reads {hr.count}; "
            f"loss first {losses[0]:.4f} last {losses[-1]:.4f} (means of "
            f"the first and last 10: {float(np.mean(losses[:10])):.4f}, "
            f"{float(np.mean(losses[-10:])):.4f}); top device time: "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top[:4]))


def fcnf0_step_split(torch, TF, trainer, B: int) -> str:
    """Where an FCNF0 step's time goes (``tools/torch_train_fcnf0.py``'s
    ``trainer`` on its device, batch ``B``): the corpus, the forward and
    backward, Adam and the whole step, each its CUDA-event ms a call over
    20 calls after warm-up, and the device functions and device-busy ms
    of one call.  Adam and the step move the trainer's parameters."""
    from diffsptk_tpu_torch.utils import prng

    dev = trainer.device
    key = prng.PRNGKey(9)
    x, t = TF.synth_batch_device(key, B, dev)
    _, g = trainer.loss_and_grads(x, t)
    state = {"key": prng.PRNGKey(99)}

    def step():
        state["key"], sub = prng.split(state["key"])
        return trainer.step(*TF.synth_batch_device(sub, B, dev))

    parts = []
    for stage, fn in (("corpus", lambda: TF.synth_batch_device(key, B, dev)),
                      ("forward and backward",
                       lambda: trainer.loss_and_grads(x, t)),
                      ("Adam", lambda: trainer.adam.update(g)),
                      ("step", step)):
        ms = cuda_ms(torch, fn, 20, warm=3)
        busy, _, n_dev, _, _ = profile_chain(torch, fn, calls=1)
        parts.append(f"{stage} {ms:.3f} ms ({n_dev:.0f} device functions, "
                     f"busy {busy:.3f} ms)")
    return "; ".join(parts)


def run_train_pitch(torch, xw, card: str) -> None:
    """[train-pitch]: the repo's training paths on the card through the
    port's trainers (tools/torch_train_fcnf0.py, torch_train_crepe_tiny.py),
    at their default batches.  FCNF0 from ``init_fcnf0_params(0)`` for
    ``TRAIN_STEPS`` steps on the device corpus (the threefry kernel:
    ``CORPUS_LAUNCHES`` a step), then ``TRAIN_RESUMED`` steps from the
    JAX package's bundled checkpoint; CREPE-tiny for ``TRAIN_STEPS``
    steps on numpy batches made before the timed window.  Each: CUDA-event
    ms a step, frames/s, busy share, peak memory, no host read in the
    timed steps, finite losses (falling from init).  The corpus's draws
    equal the twin's bit for bit and its values lie within
    ``CORPUS32_BARS`` of float64 on the same draws; one step's gradients
    in full fp32 within ``TRAIN_GRAD_BAR`` of the CPU twin's float64 ones,
    in TF32 within ``TRAIN_TF32_GRAD_BAR``.  The resumed run's npz, loaded by
    ``PitchExtractionByFCNF0(weights=path)`` on the card, gives a finite
    f0 on ``synth_speech``."""
    import os
    import tempfile

    from diffsptk_tpu_torch import twins
    from diffsptk_tpu_torch.kernels import threefry
    from diffsptk_tpu_torch.ops.pitch_nn import (
        PitchExtractionByFCNF0,
        bundled_weights_path,
        init_crepe_params,
        init_fcnf0_params,
    )
    from diffsptk_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    TF = train_tool("torch_train_fcnf0")
    TC = train_tool("torch_train_crepe_tiny")
    dev = xw.device
    B = TRAIN_BATCH["fcnf0"]

    # the device corpus: the kernel's draws against the twin's on the card
    # and on the host; its values against float64 on the same draws
    key = prng.PRNGKey(7)
    draws = TF.corpus_draws(key, B, dev)
    with twins():
        twin = TF.corpus_draws(key, B, dev)
    host = TF.corpus_draws(key, B, "cpu")
    differ = [k for k in draws if not (torch.equal(draws[k], twin[k])
                                       and torch.equal(draws[k].cpu(),
                                                       host[k]))]
    check(not differ, f"[train-pitch] corpus draws differ from the twin's: "
          f"{differ}")
    x32, t32 = TF.synth_from_draws(draws)
    x64, t64 = TF.synth_from_draws(
        {k: (v.double() if v.is_floating_point() else v).cpu()
         for k, v in draws.items()})
    err_x, err_t = rel_err(torch, x32, x64), rel_err(torch, t32, t64)
    bars = TF.CORPUS32_BARS
    check(err_x <= bars["x"] and err_t <= bars["target"],
          f"[train-pitch] float32 corpus off float64: x {err_x}, target "
          f"{err_t}")

    # one step's gradients on the card against the CPU twin's, in float64
    # (the reference) and float32
    init = init_fcnf0_params(0)
    x, target = TF.synth_batch_device(prng.PRNGKey(8), B, dev)
    refs = {dt: TF.Trainer(init, "cpu", dtype=dt).loss_and_grads(
        x.cpu().to(dt), target.cpu().to(dt))[1]
        for dt in (torch.float64, torch.float32)}
    scale = max(float(g.abs().max()) for g in refs[torch.float64])

    def grad_err(grads, ref) -> float:
        return max(float((a.cpu().double() - b.double()).abs().max())
                   for a, b in zip(grads, ref)) / scale

    grads = {precision: TF.Trainer(init, dev, precision=precision)
             .loss_and_grads(x, target)[1] for precision in ("full", "tf32")}
    err = {p: grad_err(g, refs[torch.float64]) for p, g in grads.items()}
    err32 = {p: grad_err(g, refs[torch.float32]) for p, g in grads.items()}
    err_cpu32 = grad_err(refs[torch.float32], refs[torch.float64])
    check(err["full"] <= TRAIN_GRAD_BAR,
          f"[train-pitch] fp32 gradients off the CPU twin's: {err['full']}")
    check(err["tf32"] <= TRAIN_TF32_GRAD_BAR,
          f"[train-pitch] TF32 gradients off the CPU twin's: {err['tf32']}")
    print(f"[train-pitch] fcnf0 corpus B={B}: {len(draws)} draws equal to "
          f"the twin's on the card and the host; x {err_x:.3e} of max "
          f"from float64 on the same draws (bar {bars['x']}), target "
          f"{err_t:.3e} (bar {bars['target']}); one step's gradients of "
          f"max|g| from the CPU twin's in float64: full fp32 "
          f"{err['full']:.3e} (bar {TRAIN_GRAD_BAR}), TF32 "
          f"{err['tf32']:.3e} (bar {TRAIN_TF32_GRAD_BAR}); from its "
          f"float32 (for information): full fp32 {err32['full']:.3e}, TF32 "
          f"{err32['tf32']:.3e}, and the CPU's float32 from its float64 "
          f"{err_cpu32:.3e} | {card}", flush=True)

    def fcnf0_run(params: dict, steps: int):
        trainer = TF.Trainer(params, dev)
        state = {"key": prng.PRNGKey(99)}

        def step(_i):
            state["key"], sub = prng.split(state["key"])
            return trainer.step(*TF.synth_batch_device(sub, B, dev))

        torch.cuda.synchronize()
        threefry.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, ms, hr = timed_steps(torch, step, steps)
        launches = threefry.launches / steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        busy, top, n_dev, _, wall = profile_chain(torch, lambda: step(0))
        check(bool(np.isfinite(losses).all()),
              f"[train-pitch] fcnf0 loss not finite: {losses}")
        check(hr.count == 0,
              f"[train-pitch] fcnf0 steps read the card {hr.count} times "
              f"at {hr.where}")
        check(launches == TF.CORPUS_LAUNCHES,
              f"[train-pitch] {launches} threefry launches a step, "
              f"expected {TF.CORPUS_LAUNCHES}")
        return trainer, losses, ms, hr, launches, peak, (busy, top, n_dev,
                                                         wall)

    flops = {"fcnf0": 3 * conv_flops("fcnf0"),
             "crepe": 3 * conv_flops("crepe", "tiny")}
    trainer, losses, ms, hr, launches, peak, prof = fcnf0_run(init,
                                                             TRAIN_STEPS)
    check(float(np.mean(losses[-10:])) < float(np.mean(losses[:10])),
          f"[train-pitch] fcnf0 loss did not fall: {losses}")
    print(f"[train-pitch] fcnf0 from init, B={B}, {TRAIN_STEPS} steps: "
          f"threefry {launches:.1f} launches a step; "
          + train_line(torch, "fcnf0", losses, ms, hr, B, flops["fcnf0"],
                       peak, prof) + f" | {card}", flush=True)

    print(f"[train-pitch] fcnf0 step split, B={B}, CUDA events over 20 "
          f"calls each: " + fcnf0_step_split(torch, TF, trainer, B)
          + f" | {card}", flush=True)

    bundled = dict(np.load(bundled_weights_path("fcnf0_synth.npz")))
    trainer, losses, ms, hr, launches, peak, prof = fcnf0_run(
        bundled, TRAIN_RESUMED)
    print(f"[train-pitch] fcnf0 resumed from the bundled checkpoint, B={B}, "
          f"{TRAIN_RESUMED} steps: threefry {launches:.1f} launches a step; "
          + train_line(torch, "fcnf0", losses, ms, hr, B, flops["fcnf0"],
                       peak, prof) + f" | {card}", flush=True)

    # the checkpoint round trip: the resumed run's npz on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fcnf0.npz")
        trainer.save(path)
        ext = PitchExtractionByFCNF0(80, 16000, weights=path, device=dev)
    same = all(torch.equal(ext.params[k], p.detach())
               for k, p in trainer.params.items())
    check(same, "[train-pitch] the checkpoint's weights changed on loading")
    rows = xw[:4]
    with torch.no_grad():
        f0 = ext.calc_pitch(rows)
    check(bool(torch.isfinite(f0).all()),
          "[train-pitch] f0 from the trained checkpoint is not finite")
    T = rows.shape[-1]
    truth = torch.as_tensor(synth_f0(rows.shape[0], T)[:, np.minimum(
        np.arange(f0.shape[-1]) * 80, T - 1)], device=dev, dtype=f0.dtype)
    voiced = f0 > 0
    cents = cents_diff(f0[voiced], truth[voiced]).abs()
    med_cents = float(cents.median()) if cents.numel() else float("nan")

    # CREPE-tiny, on numpy batches made before the timed window
    Bc = TRAIN_BATCH["crepe"]
    rng = np.random.default_rng(0)
    batches = [tuple(torch.as_tensor(a, device=dev)
                     for a in TC.synth_batch(rng, Bc))
               for _ in range(TRAIN_STEPS)]
    crepe = TC.Trainer(init_crepe_params("tiny", seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, hr = timed_steps(torch, lambda i: crepe.step(*batches[i]),
                                 TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    busy, top, n_dev, _, wall = profile_chain(
        torch, lambda: crepe.step(*batches[-1]))
    running = [p for k, p in crepe.params.items() if "running_" in k]
    check(bool(np.isfinite(losses).all())
          and all(bool(torch.isfinite(p).all()) for p in running),
          f"[train-pitch] crepe loss or running statistics not finite: "
          f"{losses}")
    check(hr.count == 0, f"[train-pitch] crepe steps read the card "
          f"{hr.count} times at {hr.where}")
    check(float(np.mean(losses[-10:])) < float(np.mean(losses[:10])),
          f"[train-pitch] crepe loss did not fall: {losses}")
    print(f"[train-pitch] crepe-tiny from init, B={Bc}, {TRAIN_STEPS} steps "
          f"(batches made on the host before the timed window): "
          + train_line(torch, "crepe", losses, ms, hr, Bc, flops["crepe"],
                       peak, (busy, top, n_dev, wall)) + f" | {card}",
          flush=True)
    print(f"[train-pitch] checkpoint: the resumed run's npz loaded by "
          f"PitchExtractionByFCNF0 on the card, weights equal; f0 of "
          f"{rows.shape[0]} x {rows.shape[-1]} finite, voiced on "
          f"{100 * float(voiced.float().mean()):.1f} % of frames, median "
          f"{med_cents:.1f} cents from the known glide; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s | {card}", flush=True)


TC_PEAK = 989e12      # H100 SXM dense bf16 tensor-core rate, flop/s
TC_TWIN_BARS = {"HIGH": 2e-5, "DEFAULT": 3e-3}   # tests/test_torch_gpu.py
HIGH_FP32_BAR = 2e-4  # HIGH against the fp32 kernel (test_pallas_mlsa.py:76)
DEFAULT_F64_TIMES = 10.0   # DEFAULT: within 10x its CPU distance from f64
HIGH_CHAIN_BAR = 5e-2  # the HIGH round trip against the fp32 kernel path
TC_COUNTERS = ("launches_high", "launches_default",
               "launches_high_unchunked", "launches_default_unchunked")
TC_ROWS = {("chunked", "HIGH"): "mlsa_cascade_high",
           ("chunked", "DEFAULT"): "mlsa_cascade_bf16",
           ("unchunked", "HIGH"): "mlsa_cascade_high_unchunked",
           ("unchunked", "DEFAULT"): "mlsa_cascade_bf16_unchunked"}


TC_KERNELS = ("tc_fwd_kernel", "tc_inv_kernel", "tc_prep_kernel")
"""The device functions of either tensor-core cascade entry: a prologue a
call, then the forward and the inverse product a stage."""


def tc_ptxas(log: str) -> str:
    """ptxas' registers and spills of each instance of the tensor-core
    kernels: the forward and inverse kernel of each entry (chunked or
    unchunked) and arm."""
    out, name = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln
            continue
        if not ("spill" in ln or "Used" in ln):
            continue
        for kernel in TC_KERNELS[:2]:
            if kernel not in name:
                continue
            args = name.split(kernel, 1)[1]
            arm = "HIGH" if args.startswith("ILb1E") else "DEFAULT"
            entry = "chunked" if "ELb1EE" in args[:12] else "unchunked"
            out.append(f"{entry} {arm} {kernel}: "
                       f"{ln.split(':', 1)[-1].strip()}")
    return "; ".join(out) or "not in the build log"


def tc_device_ms(torch, fn, names, calls: int = 20):
    """Device time per call of ``fn``'s device functions whose names hold
    one of ``names``, under torch.profiler: the union of their intervals
    (the programmatic dependent launches overlap), and each name's own
    summed time.  0.0 where the profiler recorded none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(n in e.name for n in names)]
    each = {n: sum(e.device_time for e in events if n in e.name)
            / 1e3 / calls for n in names}
    return union_us(events) / 1e3 / calls, each


def tc_counts(mlsa, newton) -> dict:
    """The cascade kernels' and the Newton kernel's launch counters."""
    keys = ("launches", "launches_unchunked") + TC_COUNTERS
    return {"newton": newton.launches,
            **{k: getattr(mlsa, k) for k in keys}}


def tc_zero(mlsa, newton) -> None:
    newton.launches = 0
    for k in ("launches", "launches_unchunked") + TC_COUNTERS:
        setattr(mlsa, k, 0)


def tc_bound(B: int, N: int, P: int, Q: int, n_blk: int, K: int, S: int,
             passes: int, plan_bytes: int) -> tuple[float, str]:
    """The least time of the DFT-plan cascade at one arm: per frame row and
    stage the plan products' n_blk P x 2K + 2K x 2P multiply-adds, times
    ``passes`` bf16 products (3 at HIGH), at the bf16 tensor-core peak;
    against x and y once, the coefficient spectra (Q x K complex a frame)
    once and the plans once, at the device memory's rate."""
    macs = n_blk * P * 2 * K + 2 * K * 2 * P
    t_ops = 2.0 * macs * B * N * S * passes / TC_PEAK * 1e3
    nbytes = (2 * B * N * P + 2 * B * N * Q * K) * 4.0 + plan_bytes
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tc_library_ms(torch, dev, rows: int, n_blk: int, P: int, K: int,
                  S: int, passes: int) -> tuple[float, str]:
    """The same plan products as cuBLAS bf16 GEMMs with fp32 results
    (``torch.mm(..., out_dtype=torch.float32)``): per stage ``passes``
    times (rows x n_blk P) @ (n_blk P x 2K) and (rows x 2K) @ (2K x 2P).
    A yardstick only: the port never calls it."""
    g = torch.Generator(dev).manual_seed(3)
    a1, b1, a2, b2 = (
        torch.randn(*sh, device=dev, generator=g).to(torch.bfloat16)
        for sh in ((rows, n_blk * P), (n_blk * P, 2 * K), (rows, 2 * K),
                   (2 * K, 2 * P)))

    def call():
        for _ in range(S * passes):
            torch.mm(a1, b1, out_dtype=torch.float32)
            torch.mm(a2, b2, out_dtype=torch.float32)
    return cuda_ms(torch, call, 5), "torch.mm(bf16, bf16, out_dtype=float32)"


def tc_tile_line(mlsa, B: int, N: int, P: int, Q: int, r0: int, n_blk: int,
                 K: int, precision: str, chunked: bool, n_sm: int) -> str:
    """An entry's tiles at (B, N) as its C side reports them: each
    kernel's rows x columns, ring stages, shared memory, CTAs, CTAs to an
    SM and waves."""
    t = mlsa.tc_tile(P, Q, r0, n_blk, K, precision, chunked)
    lay = t["layout"]
    M = B * (lay.pre + N + lay.after)
    ctas = {"forward": -(-M // t["fwd_step"]) * (lay.Nf // lay.bn_f),
            "inverse": -(-M // (t["rows"] - 1)) * lay.n_ctile}
    parts = []
    for name, key in (("forward", "fwd"), ("inverse", "inv")):
        per_sm = t[f"{key}_per_sm"]
        parts.append(
            f"{name} tile {t['rows']} x {t[f'{key}_cols']}, "
            f"{t[f'{key}_stages']} ring stages, {t[f'{key}_smem']} bytes "
            f"of shared memory, {ctas[name]} CTAs, {per_sm} to an SM: "
            f"{ctas[name] / max(per_sm * n_sm, 1):.2f} waves")
    return (f"{M} padded frame rows (forward row tiles step by "
            f"{t['fwd_step']}); " + "; ".join(parts) + f" on {n_sm} SMs")


def check_tc(torch, dev, chunked: bool, B: int, N: int, P: int, M: int,
             S: int, precision: str, seed: int) -> tuple[dict, str]:
    """The tensor-core cascade through one entry at one arm, at (B, N, P,
    M, S): against its twin in the same arithmetic (``TC_TWIN_BARS``); at
    HIGH against the fp32 kernel (``HIGH_FP32_BAR``); row 0 against
    float64 on the CPU, at DEFAULT within ``DEFAULT_F64_TIMES`` of the
    twin's distance there; the kernel's time, device time, the twin's and
    the cuBLAS GEMMs', and the bound."""
    from diffsptk_tpu_torch.core import full_precision
    from diffsptk_tpu_torch.kernels import mlsa
    from diffsptk_tpu_torch.kernels.mlsa_cascade import (
        chunked_geometry,
        lane_aligned_nfft,
        taylor_cascade_folded,
    )

    nfft = lane_aligned_nfft(2 * P + M + 1)
    geo = chunked_geometry(M, P, nfft)
    check((geo is not None) == chunked,
          f"[precision]: P={P}, M={M} is not the expected geometry")
    x, c, weights, a = cascade_case(torch, dev, B, N, P, M, S, seed=seed)
    xq = x.reshape(B, N, P)
    if chunked:
        Q, nf = geo

        def kernel():
            return mlsa.cascade_chunked_tc_cuda(xq, c, weights, a, P, 0, nf,
                                                precision)

        def fp32():
            return mlsa.cascade_chunked_cuda(xq, c, weights, a, P, 0, nf)
        plan = mlsa.tc_plans(nf, P - 1, P, 0, precision, x.device, Q,
                             True)[:7]
    else:
        Q = 1

        def kernel():
            return mlsa.cascade_unchunked_tc_cuda(xq, c, weights, a, P, 0,
                                                  nfft, precision)

        def fp32():
            return mlsa.cascade_unchunked_cuda(xq, c, weights, a, P, 0, nfft)
        plan = mlsa.tc_plans(nfft, M, P, 0, precision, x.device)[:7]
    kernel, fp32 = full_precision(kernel), full_precision(fp32)
    twin = full_precision(lambda: taylor_cascade_folded(
        x, c, weights, a, P, 0, nfft, precision))
    y_k = kernel().reshape(B, N * P)
    y_t, y_f = twin(), fp32().reshape(B, N * P)
    torch.cuda.synchronize()
    scale = float(y_t.abs().max())
    err = float((y_k - y_t).abs().max())
    err_f = float((y_k - y_f).abs().max()) / scale
    check(err <= TC_TWIN_BARS[precision] * scale,
          f"[precision] {precision} at P={P}, M={M} disagrees with its "
          f"twin: {err / scale:.3e} of max|y| > {TC_TWIN_BARS[precision]}")
    if precision == "HIGH":
        check(err_f <= HIGH_FP32_BAR,
              f"[precision] HIGH at P={P}, M={M} is {err_f:.3e} of max|y| "
              f"from the fp32 kernel (bar {HIGH_FP32_BAR})")
    row = [t[:1].cpu() for t in (x, c)] + [t.cpu() for t in (weights, a)]
    y64 = taylor_cascade_folded(*(t.double() for t in row), P, 0, nfft)
    y_cpu = taylor_cascade_folded(*row, P, 0, nfft, precision)
    m64 = float(y64.abs().max())
    d_cpu = float((y_cpu.double() - y64).abs().max()) / m64
    d_k = float((y_k[:1].double().cpu() - y64).abs().max()) / m64
    if precision == "DEFAULT":
        check(d_k <= DEFAULT_F64_TIMES * d_cpu,
              f"[precision] DEFAULT at P={P}, M={M}: row 0 {d_k:.3e} of "
              f"max|y| from float64, over {DEFAULT_F64_TIMES} x the CPU "
              f"twin's {d_cpu:.3e}")
    del y_k, y_t, y_f
    ms = cuda_ms(torch, kernel, 10)
    dev_ms, each = tc_device_ms(torch, kernel, TC_KERNELS)
    functions = (
        f"; device functions ({1 + 2 * S} launches: a prologue, then "
        f"forward and inverse a stage; their union is the device time): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in each.items()))
    twin_ms = cuda_ms(torch, twin, 3, warm=1)
    fp32_ms = cuda_ms(torch, fp32, 10)
    f_hi, f_lo, g_hi, g_lo, _, n_blk, K = plan
    passes = 3 if precision == "HIGH" else 1
    plan_bytes = sum(t.numel() * t.element_size() for t in (
        (f_hi, f_lo, g_hi, g_lo) if passes == 3 else (f_hi, g_hi)))
    bound, by = tc_bound(B, N, P, Q, n_blk, K, S, passes, plan_bytes)
    lib_ms, lib_kind = tc_library_ms(torch, dev, B * N, n_blk, P, K, S,
                                     passes)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tile = tc_tile_line(mlsa, B, N, P, Q, plan[4], n_blk, K, precision,
                        chunked, n_sm)
    flops = 2.0 * (n_blk * P * 2 * K + 4 * K * P) * B * N * S * passes
    summary = (f"{'chunked' if chunked else 'unchunked'} {precision} P={P} "
               f"M={M} (Q={Q}, K={K}, n_blk={n_blk}) S={S}: |kernel-twin| "
               f"{err / scale:.3e} of max|y| (bar "
               f"{TC_TWIN_BARS[precision]}), |kernel-fp32 kernel| "
               f"{err_f:.3e}, row 0 from float64: kernel {d_k:.3e}, CPU twin "
               f"{d_cpu:.3e}; kernel {ms:.4f} ms per call ({S} stages), "
               f"device {dev_ms:.4f} ms, {flops / 1e9:.2f} GFLOP at "
               f"{flops / (dev_ms or ms) / 1e9:.1f} TFLOP/s; bound "
               f"{bound:.4f} ms ({by}, {ms / bound:.1f}x); fp32 kernel "
               f"{fp32_ms:.4f} ms; twin {twin_ms:.3f} ms; library "
               f"({lib_kind}) {lib_ms:.4f} ms; {tile}{functions}")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=twin_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms), summary


def run_precision(torch, xs, card: str, ptxas: str) -> dict:
    """[precision]: the cascade's reduced-precision arms on the tensor-core
    kernel.  Each entry and arm at full width (``check_tc``): the chunked
    one at the flagship's geometry, the unchunked one at [chain48]'s.
    Then the slice's path, each drive with the counters zeroed just
    before it and read just after: MelCepstralVocoder(cascade="fused",
    cascade_precision="HIGH").analysis_synthesis on the flagship's 32 x
    19,200 (Newton 10, the HIGH chunked entry 40; SNR at least 20 dB,
    within ``HIGH_CHAIN_BAR`` of the fp32 kernel path), synthesize at
    DEFAULT (20 launches; row 0 within ``DEFAULT_F64_TIMES`` of the CPU
    twin's distance from float64), the 48 kHz vocoder at HIGH (Newton 10,
    the unchunked HIGH entry 50; against float64 as [chain48] holds it:
    HIGH's round trip there reads about 19 dB from x, in the twin as in
    the kernel, so the 20 dB bar is the flagship's only) and its
    synthesize at DEFAULT (25).  Returns the kernel line's rows."""
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import mlsa, newton

    t0 = time.time()
    rows, lines = {}, []
    for chunked, P in ((True, 80), (False, 240)):
        for precision in ("HIGH", "DEFAULT"):
            row, line = check_tc(torch, "cuda", chunked, 32, 240, P, 199, 20,
                                 precision, seed=21)
            rows[TC_ROWS["chunked" if chunked else "unchunked",
                         precision]] = row
            lines.append(line)
    for line in lines:
        print(f"[precision] {line} | {card}", flush=True)

    def drive(name, fn, want):
        tc_zero(mlsa, newton)
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in tc_counts(mlsa, newton).items() if v}
        check(got == want, f"[precision] {name}: launches {got}, expected "
              f"{want}")
        return out, got

    Bv, T = xs.shape
    voc = MelCepstralVocoder(cascade="fused", cascade_precision="HIGH",
                             device="cuda", dtype=torch.float32)
    full = MelCepstralVocoder(cascade="fused", device="cuda",
                              dtype=torch.float32)
    low = MelCepstralVocoder(cascade="fused", cascade_precision="DEFAULT",
                             device="cuda", dtype=torch.float32)
    with torch.no_grad():
        y, launches_a = drive("flagship HIGH round trip",
                              lambda: voc.analysis_synthesis(xs),
                              {"newton": 10, "launches_high": 40})
        check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (Bv, T),
              "[precision] the HIGH round trip is not finite")
        y_f = full.analysis_synthesis(xs)
        snr, snr_f = snr_db(torch, xs, y), snr_db(torch, xs, y_f)
        d_f = rel_err(torch, y, y_f)
        check(snr >= 20.0, f"[precision] HIGH round-trip SNR {snr:.2f} dB "
              "is below 20 dB")
        check(d_f <= HIGH_CHAIN_BAR, f"[precision] the HIGH round trip is "
              f"{d_f:.3e} of max|y| from the fp32 kernel path")
        high_calls = cuda_call_ms(torch, lambda: voc.analysis_synthesis(xs),
                                  20)
        full_calls = cuda_call_ms(torch, lambda: full.analysis_synthesis(xs),
                                  20)
        mc = voc.analyze(xs)
        e, launches_b = drive("flagship DEFAULT synthesis",
                              lambda: low.synthesize(xs, mc),
                              {"launches_default": 20})
        low64 = MelCepstralVocoder(cascade="folded", device="cpu",
                                   dtype=torch.float64)
        e64 = low64.synthesize(xs[:1].double().cpu(), mc[:1].double().cpu())
        low32 = MelCepstralVocoder(cascade="fused",
                                   cascade_precision="DEFAULT", device="cpu",
                                   dtype=torch.float32)
        d_cpu = rel_err(torch, low32.synthesize(xs[:1].cpu(), mc[:1].cpu()),
                        e64)
        d_k = rel_err(torch, e[:1].cpu(), e64)
        check(d_k <= DEFAULT_F64_TIMES * d_cpu,
              f"[precision] DEFAULT synthesis row 0 {d_k:.3e} of max|y| "
              f"from float64, over {DEFAULT_F64_TIMES} x the CPU's "
              f"{d_cpu:.3e}")
        low_ms = float(np.median(cuda_call_ms(
            torch, lambda: low.synthesize(xs, mc), 20)))
        full_syn_ms = float(np.median(cuda_call_ms(
            torch, lambda: full.synthesize(xs, mc), 20)))
        del y, y_f, e, e64
        S48 = 25
        xs48 = torch.as_tensor(synth_speech(32, 57600, sr=48000),
                               device="cuda")
        kw48 = dict(frame_length=1200, frame_period=240, fft_length=2048,
                    cep_order=24, alpha=0.55, taylor_order=S48,
                    cascade="fused", device="cuda", dtype=torch.float32)
        voc48 = MelCepstralVocoder(cascade_precision="HIGH", **kw48)
        y48, launches_c = drive("48 kHz HIGH round trip",
                                lambda: voc48.analysis_synthesis(xs48),
                                {"newton": 10,
                                 "launches_high_unchunked": 2 * S48})
        check(bool(torch.isfinite(y48).all()),
              "[precision] the 48 kHz HIGH round trip is not finite")
        # As [chain48]: each path against a float64 run on the card.  The
        # 48 kHz cascades cancel heavily, so HIGH's round trip sits near 19
        # dB from x in either path; the kernel path may lie at most 3 dB
        # below its twin's distance from float64.
        with twins():
            y48_t = voc48.analysis_synthesis(xs48)
        kw64 = dict(kw48, cascade="folded", dtype=torch.float64)
        y48_64 = MelCepstralVocoder(**kw64).analysis_synthesis(
            xs48.double())
        snr48_k, snr48_t = (snr_db(torch, y48_64, y)
                            for y in (y48, y48_t))
        check(snr48_k >= snr48_t - 3.0,
              f"[precision] 48 kHz HIGH round trip: kernel path "
              f"{snr48_k:.2f} dB from float64, more than 3 dB below its "
              f"twin's {snr48_t:.2f} dB")
        snr48, snr48_xt, snr48_x64 = (snr_db(torch, xs48, y)
                                      for y in (y48, y48_t, y48_64))
        del y48_t, y48_64
        ms48 = float(np.median(cuda_call_ms(
            torch, lambda: voc48.analysis_synthesis(xs48), 10)))
        mc48 = voc48.analyze(xs48)
        low48 = MelCepstralVocoder(cascade_precision="DEFAULT", **kw48)
        e48, launches_d = drive("48 kHz DEFAULT synthesis",
                                lambda: low48.synthesize(xs48, mc48),
                                {"launches_default_unchunked": S48})
        check(bool(torch.isfinite(e48).all()),
              "[precision] the 48 kHz DEFAULT synthesis is not finite")
        del y48, e48, xs48
    launches = {}
    for got in (launches_a, launches_b, launches_c, launches_d):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    for (entry, precision), name in TC_ROWS.items():
        key = ("launches_" + ("high" if precision == "HIGH" else "default")
               + ("_unchunked" if entry == "unchunked" else ""))
        rows[name]["launches"] = launches[key]
    med, med_f = float(np.median(high_calls)), float(np.median(full_calls))
    print(f"[precision] path: launches {launches_a} (flagship HIGH round "
          f"trip), {launches_b} (DEFAULT synthesis), {launches_c} (48 kHz "
          f"HIGH round trip), {launches_d} (48 kHz DEFAULT synthesis); "
          f"HIGH round trip SNR {snr:.2f} dB (fp32 kernel path {snr_f:.2f} "
          f"dB), {d_f:.3e} of max|y| from the fp32 kernel path (bar "
          f"{HIGH_CHAIN_BAR}), median {med:.3f} ms a call against "
          f"{med_f:.3f} ms (fp32 kernel, p90 "
          f"{float(np.percentile(high_calls, 90)):.3f} / "
          f"{float(np.percentile(full_calls, 90)):.3f}); DEFAULT synthesis "
          f"row 0 {d_k:.3e} of max|y| from float64 (CPU twin {d_cpu:.3e}, "
          f"bar {DEFAULT_F64_TIMES}x), median {low_ms:.3f} ms against "
          f"{full_syn_ms:.3f} ms (fp32 kernel); 48 kHz HIGH round trip "
          f"against float64: kernel path {snr48_k:.2f} dB, twin path "
          f"{snr48_t:.2f} dB (kernel at most 3 dB below); SNR against x: "
          f"kernel path {snr48:.2f} dB, twin path {snr48_xt:.2f} dB, float64 "
          f"{snr48_x64:.2f} dB; median {ms48:.3f} ms; ptxas {ptxas}; phase "
          f"{time.time() - t0:.1f} s | {card}", flush=True)
    return rows


EXAMPLES_CARD = ("torch_analysis_synthesis", "torch_neural_pitch",
                 "torch_world_vocoder")


def run_examples(torch, card: str) -> None:
    """[examples]: the three one-card examples (examples/torch_*.py) once
    each on the card, in this process, on their synthetic speech (19,200
    samples): the round trip's SNR at least 20 dB, CREPE-tiny within 50
    cents of YIN, WORLD's spectrogram correlation at least 0.8."""
    import contextlib
    import importlib.util
    import io
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    bars = {"torch_analysis_synthesis": lambda v: v >= 20.0,
            "torch_neural_pitch": lambda v: v <= 50.0,
            "torch_world_vocoder": lambda v: v >= 0.8}
    out = []
    for name in EXAMPLES_CARD:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(here, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            value = mod.main([])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        check(bars[name](value), f"[examples] {name}: {value} misses its "
              f"bar; it printed:\n{printed.getvalue()}")
        first = printed.getvalue().strip().splitlines()
        out.append(f"{name}: {value:.3f} ({took:.2f} s; "
                   f"\"{first[-1] if name != 'torch_neural_pitch' else first[1]}\")")
    print("[examples] " + "; ".join(out) + f" | {card}", flush=True)


def main() -> int:
    import torch

    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from diffsptk_tpu_torch import MelCepstralVocoder, twins
    from diffsptk_tpu_torch.kernels import build, mcep_residual, mlsa, newton
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
    solve_ptxas = usage_line(
        ptxas_usage(logs.get("spd_solve", ""), "spd_solve_kernel"), pick=24)
    gather_ptxas = usage_line(
        ptxas_usage(logs.get("gather", ""), "gather_kernel"))
    for src, log in logs.items():
        took = (f"nvcc {build.seconds[src]:.1f} s; "
                if src in build.seconds else "")
        if src == "newton":   # one instance per order
            print(f"[build] newton: {took}newton_kernel {newton_ptxas}",
                  flush=True)
            continue
        if src == "spd_solve":   # one instance per order rounded up to 8
            print(f"[build] spd_solve: {took}spd_solve_kernel "
                  f"{solve_ptxas}, "
                  + ptxas_smem_spills(log, "spd_solve_kernel"), flush=True)
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
                "spd_solve").spd_solve_smem_bytes(64),
            **{f"mlsa_cascade_tc {entry} {arm} ({geo})": {
                k: v for k, v in mlsa.tc_tile(*args, arm, entry == "chunked")
                .items() if k != "layout"}
               for entry, geo, args in (
                   ("chunked", "P=80, Q=3", (80, 3, 2, 3, 128)),
                   ("unchunked", "P=240", (240, 1, 2, 3, 384)))
               for arm in ("HIGH", "DEFAULT")}}
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

    report["newton_toephank"] = check_toephank(torch, dev, card,
                                               newton_ptxas)

    # 4. K2: the cascade kernel's chunked entry at the flagship geometry
    report["mlsa_cascade"], k2 = check_cascade(
        torch, dev, card, "K2", True, 32, 240, 80, 199, 20, 21, ptxas)
    print(f"[K2] B=32 N=240 {k2} | {card}", flush=True)

    # 5. K4 and 6. K5: the SPD solve and scan kernels
    report["spd_solve"] = check_spd_solve(torch, dev, card)
    report["scan"] = check_scan(torch, dev, card)

    # 6a. K9: the mcep residual kernel at the benchmark's shapes
    report["mcep_residual"] = check_mcep_residual(
        torch, dev, card, usage_line(ptxas_usage(
            logs.get("mcep_residual", ""), "mcep_residual_kernel"), pick=25))

    # 7. the flagship chain
    Bv, T = 32, 19200
    xs = torch.as_tensor(synth_speech(Bv, T), device=dev)
    voc = MelCepstralVocoder(cascade="fused", device="cuda",
                             dtype=torch.float32)
    newton.launches = 0
    mlsa.launches = 0
    with torch.no_grad():
        mcep_residual.launches = 0
        mc = voc.analyze(xs)
        torch.cuda.synchronize()
        n_analyze = voc.mcep.n_iter
        residual_launches = mcep_residual.launches
        check(residual_launches == n_analyze,
              f"mcep residual kernel launched {residual_launches} times in "
              f"one analyze call, expected {n_analyze}")
        newton.launches = 0
        y = voc.analysis_synthesis(xs)
        torch.cuda.synchronize()
        launches = {"newton": newton.launches, "mlsa_cascade": mlsa.launches}
        check(launches["newton"] == n_analyze,
              f"Newton kernel launched {launches['newton']} times, "
              f"expected {n_analyze}")
        S = 20                                # the model's Taylor order
        check(launches["mlsa_cascade"] == 2 * S,
              f"cascade kernel launched {launches['mlsa_cascade']} times, "
              f"expected {2 * S}")
        check(tuple(y.shape) == (Bv, T) and bool(torch.isfinite(y).all()),
              "chain output is not finite or has the wrong shape")
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
        im_busy, _, _, im_gaps, im_wall = profile_chain(
            torch, lambda: mlsa.taylor_cascade(*im_args, *geo), calls=5,
            stages=S)
        print(f"[imlsa] B={Bv} N={mc.shape[-2]}: max sum|c| {c_sum:.3f}, "
              f"max|e| {e_scale:.4e}; |kernel-twin| {err_e:.3e} (tol 2e-3 "
              f"* max|e|); against float64: kernel max {max_k:.3e} rms "
              f"{rms_k:.3e}, twin max {max_p:.3e} rms {rms_p:.3e} (rms "
              f"ratio {rms_k / rms_p:.3f}, tol 2); cascade call median "
              f"{im_ms:.4f} ms (p90 {float(np.percentile(im_calls, 90)):.4f}"
              f", {len(im_calls)} calls), {busy_share(im_busy, im_wall)}; "
              f"host enqueue "
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
    busy_ms, top, n_device, gaps, wall_ms = profile_chain(
        torch, lambda: voc.analysis_synthesis(xs), stages=S)
    for key, count in launches.items():
        report[key]["launches"] = count
    report["mcep_residual"]["launches"] = residual_launches
    print(f"[chain] B={Bv} T={T}: launches {launches}, mcep residual "
          f"{residual_launches} in one analyze call; |mc kernel-twin| "
          f"{err_mc:.3e}; |y kernel-twin| {err_y:.3e} (tol {tol_y} * "
          f"{y_scale:.3f}); row 0 against CPU float64: kernel path "
          f"{err_64:.3e}, twin path {err_64_p:.3e} (tol {tol_y} * "
          f"{scale_64:.3f}); SNR {snr:.2f} dB; "
          f"median {chain_ms:.3f} ms per call (p90 {chain_p90:.3f}, "
          f"{len(calls)} calls), {rate:.1f} samples/s; twin path "
          f"{chain_plain_ms:.3f} ms | {card}", flush=True)

    print(f"[profile] {busy_share(busy_ms, wall_ms)} per call, against "
          f"the chain's median {chain_ms:.3f} ms, in {n_device:.0f} device "
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
    launches_w, gather_sites, ola_sites, noise_sites, _ = run_world(
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

    # 18.-22. the neural pitch trackers, WORLD with FCNF0 (configs[3] as
    #     bench_all.py names it), STRAIGHT, the excitation, the inverse STFT
    run_pitch(torch, xw, card, "fcnf0", {}, "pitch-fcnf0")
    run_pitch(torch, xw, card, "crepe", dict(model="tiny"), "pitch-crepe")
    *_, f0_w = run_world(torch, xw, card, "d4c", "world-fcnf0", full=True,
                         pitch_algorithm="fcnf0", f0_cents=TF32_CENTS)
    run_straight(torch, xw, f0_w, card)
    run_excite(torch, f0_w, card)
    run_istft(torch, xw, card)

    # 23.-26. the filterbank battery (configs[4]) and the rest of MLSA
    #     synthesis: the stages cascade, single-stage, freq-domain, Pade
    xb = torch.as_tensor(synth_speech(8, 76800), device=dev)
    run_battery(torch, xb, card)
    run_battery_long(torch, xb, card, BATTERY_LONG_T)
    del xb
    run_mglsadf_mode(torch, xw, card, "multi-stage", cascade="stages")
    run_mglsadf_mode(torch, xw, card, "multi-stage", cascade="folded")
    run_mglsadf_mode(torch, xw, card, "single-stage")
    run_mglsadf_mode(torch, xw, card, "freq-domain")
    run_pade(torch, xw[:, :3200].contiguous(), card)

    # 27. and 28. mel-generalized cepstral analysis-synthesis, and the
    #     slice's other analysis modules
    launches_mgc = run_mgc(torch, xw, card)
    report["newton_toephank"]["launches"] = launches_mgc["newton_toephank"]
    run_analysis_rest(torch, xw, card)

    # 29.-32. the speech-feature front end (PLP-24 takes the SPD solve
    #     kernel), gammatone (the scan kernel's complex entry), Griffin-Lim
    #     and the slice's other signal ops
    sp_w, feats = run_features(torch, xw, card)
    run_gammatone(torch, xw, card)
    run_griffin(torch, sp_w, xw.shape[-1], card)
    run_ops_rest(torch, xw, sp_w, feats["mfcc"], feats["plp24"], card)
    del sp_w, feats

    # 33.-36. the learners at their users' width, the misc ops, every
    #     function of the stateless API (the Newton and SPD solve kernels
    #     through it), and the utilities
    data = learner_data(torch, 320, 19200, dev)
    gmm_params = run_learners(torch, data, card)
    joint = sharded_joint(torch, data)
    del data
    run_misc(torch, xw, card)
    run_functional(torch, xw, card)
    run_io(torch, xw, gmm_params, card)

    # 37. and 38. the sharded paths through NCCL: one rank on this card,
    #     then one rank a card where there are several
    xb = torch.as_tensor(synth_speech(8, 76800), device=dev)
    run_sharded(torch, xw, xb, joint, card)
    run_sharded_multi(torch, xw, xb, joint, card)
    del xb, joint

    # 39. the JAX package's multi-chip training step through every sharded
    #     path, then across cards where there are several
    run_sharded_train(torch, card)

    # 40. the training paths: the pitch networks' trainers
    run_train_pitch(torch, xw, card)

    # 41. the cascade's reduced-precision arms on the tensor cores, and
    # 42. the one-card examples
    report.update(run_precision(
        torch, xw, card, tc_ptxas(logs.get("mlsa_cascade_tc", ""))))
    run_examples(torch, card)

    kernels = []
    meta = {
        "newton": ("cuda", "diffsptk_tpu_torch/csrc/newton.cu",
                   "diffsptk_tpu/kernels/pallas_newton.py:44"),
        "newton_toephank": (
            "cuda", "diffsptk_tpu_torch/csrc/newton.cu",
            "diffsptk_tpu/kernels/pallas_newton.py:44 (toephank_solve, "
            ":241)"),
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
                     "(jax.random.normal; not a Pallas kernel); "
                     "tools/train_fcnf0.py:113-189 (jax.random.uniform, "
                     "normal and randint's bits)"),
        "mcep_residual": ("cuda", "diffsptk_tpu_torch/csrc/mcep_residual.cu",
                          "diffsptk_tpu/ops/mcep.py:186 (left to XLA; not "
                          "a Pallas kernel)"),
    }
    for (entry, precision), key in TC_ROWS.items():
        meta[key] = (
            "cuda", "diffsptk_tpu_torch/csrc/mlsa_cascade_tc.cu",
            "diffsptk_tpu/kernels/pallas_mlsa.py:"
            + {("chunked", "HIGH"): "260",
               ("chunked", "DEFAULT"): "330 (at precision DEFAULT)",
               ("unchunked", "HIGH"): "119",
               ("unchunked", "DEFAULT"): "175 (at precision DEFAULT)"}[
                   entry, precision])
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
