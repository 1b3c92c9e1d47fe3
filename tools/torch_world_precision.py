#!/usr/bin/env python3
"""How far the port's float32 WORLD analysis on the card lies from float64.

    python3 tools/torch_world_precision.py

On the synthetic speech of chip_smoke.py (32 x 19,200 samples, 16 kHz),
with one numpy dither table for every run and the f0 of one float32 YIN
run, computes D4C's aperiodicity and CheapTrick's envelope on the card in
float32 and float64 and on the CPU in float32 and float64 (rows 0..3).
Prints, against the CPU float64 run: the max, 95th percentile and
correlation of the aperiodicity, and the envelope's max difference per
frame's max; then the distance from float64 of every stage call of D4C
(windowed waveforms, DC corrections, smoothings) on the card and on the
CPU in float32.  With the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import diffsptk_tpu_torch as pt
    from chip_smoke import synth_speech
    from diffsptk_tpu_torch.ops import ap as ap_mod
    from diffsptk_tpu_torch.ops import world_common as wc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tables = {}

    def dither(shape, dtype, device):
        if tuple(shape[1:]) not in tables:
            tables[tuple(shape[1:])] = np.random.default_rng(5).standard_normal(
                (32,) + tuple(shape[1:]))
        return torch.as_tensor(tables[tuple(shape[1:])][:shape[0]],
                               dtype=dtype, device=device)

    wc.dither_noise = dither
    x = synth_speech(32, 19200)
    rows = 4
    with torch.no_grad():
        f0 = pt.Pitch(80, 16000, out_format="f0", device="cuda",
                      dtype=torch.float32)(torch.as_tensor(x, device="cuda"))

        def analyse(device, dtype, n):
            xt = torch.as_tensor(x[:n], device=device, dtype=dtype)
            ft = f0[:n].to(device=device, dtype=dtype)
            a = pt.Aperiodicity(80, 16000, 1024, algorithm="d4c",
                                device=device, dtype=dtype)(xt, ft)
            s = pt.PitchAdaptiveSpectralAnalysis(80, 16000, 1024,
                                                 device=device,
                                                 dtype=dtype)(xt, ft)
            return a[:rows].double().cpu(), s[:rows].double().cpu()

        ref_ap, ref_sp = analyse("cpu", torch.float64, rows)
        runs = {"card float32": analyse("cuda", torch.float32, 32),
                "card float64": analyse("cuda", torch.float64, 32),
                "CPU float32": analyse("cpu", torch.float32, rows)}
        # Where the float32 error enters D4C: every stage call's output,
        # card float32 and CPU float32 against CPU float64, as the max over
        # frames of |difference| / the frame's max|value|.
        stages = ("get_windowed_waveform", "dc_correction",
                  "linear_smoothing")
        tapes = {}
        for key, device, dtype, n in (("cpu64", "cpu", torch.float64, rows),
                                      ("card32", "cuda", torch.float32, 32),
                                      ("cpu32", "cpu", torch.float32, rows)):
            tape = tapes[key] = []
            origs = {name: getattr(ap_mod, name) for name in stages}

            def spy(name):
                def wrapped(*args, **kwargs):
                    out = origs[name](*args, **kwargs)
                    tape.append((name, out[:rows].double().cpu()))
                    return out
                return wrapped

            for name in stages:
                setattr(ap_mod, name, spy(name))
            try:
                pt.Aperiodicity(80, 16000, 1024, algorithm="d4c",
                                device=device, dtype=dtype)(
                    torch.as_tensor(x[:n], device=device, dtype=dtype),
                    f0[:n].to(device=device, dtype=dtype))
            finally:
                for name in stages:
                    setattr(ap_mod, name, origs[name])
        for i, (name, ref) in enumerate(tapes["cpu64"]):
            scale = ref.abs().amax(-1, True).clamp(min=1e-30)
            errs = [float(((tapes[k][i][1] - ref).abs() / scale).max())
                    for k in ("card32", "cpu32")]
            print(f"[precision] D4C stage {i} {name}: card float32 "
                  f"{errs[0]:.3e}, CPU float32 {errs[1]:.3e} of each "
                  f"frame's max | {card}", flush=True)
    for name, (a, s) in runs.items():
        d = (a - ref_ap).abs()
        r = float(np.corrcoef(a.numpy().ravel(), ref_ap.numpy().ravel())[0, 1])
        e = float(((s - ref_sp).abs() / ref_sp.amax(-1, True)).max())
        print(f"[precision] {name} against CPU float64, rows 0..{rows - 1}: "
              f"aperiodicity max {float(d.max()):.3e}, p95 "
              f"{float(d.quantile(0.95)):.3e}, correlation {r:.4f}; "
              f"envelope max {e:.3e} of each frame's max | {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
