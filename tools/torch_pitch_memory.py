#!/usr/bin/env python3
"""Peak device memory and time of the neural pitch trackers' networks in
one pass against chunks of frames, as the frame count grows.

    python3 tools/torch_pitch_memory.py

The frames are those of chip_smoke.py's [pitch-fcnf0] and [pitch-crepe]
calls (32 x 19,200 samples of ``synth_speech`` at 16 kHz, 7,712 frames of
1,024 samples), repeated 1, 2, 4, 8 and 16 times.  For FCNF0, CREPE
"tiny" and CREPE "full" (seeded random weights; neither memory nor time
depends on the values), each at the extractor's ``PRECISION``, it runs
the network's forward over all frames in one pass and then 2,048 frames
at a time, and prints for each the peak memory allocated above what was
held before (``torch.cuda.max_memory_allocated``) and the CUDA-event ms
per call (mean of 3 after a warm-up), or that the card ran out of memory,
with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CHUNK = 2048


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    if not torch.cuda.is_available():
        print("torch_pitch_memory: no CUDA device", file=sys.stderr)
        return 1
    sm = _smoke()
    card = sm.smi()
    xs = torch.as_tensor(sm.synth_speech(32, 19200), device="cuda").float()
    for algo, kw in (("fcnf0", {}), ("crepe", dict(model="tiny")),
                     ("crepe", dict(model="full", weights=None))):
        ext = pt.Pitch(80, 16000, algorithm=algo, device="cuda",
                       dtype=torch.float32, **kw).extractor
        name = algo if algo == "fcnf0" else f"crepe-{ext.model}"
        prec = ext.PRECISION
        with torch.no_grad():
            frames = ext.frames(xs).reshape(-1, 1024)

        def fwd(f):
            if algo == "fcnf0":
                return nn_.fcnf0_forward(ext.params, f, precision=prec)
            return nn_.crepe_forward(ext.params, f, ext.model,
                                     precision=prec)

        for mult in (1, 2, 4, 8, 16):
            f = frames.repeat(mult, 1)
            parts = []
            for label, run in (
                    ("one pass", lambda f=f: fwd(f)),
                    (f"chunks of {CHUNK}", lambda f=f: torch.cat(
                        [fwd(f[i:i + CHUNK])
                         for i in range(0, f.shape[0], CHUNK)]))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                try:
                    with torch.no_grad():
                        run()
                        torch.cuda.synchronize()
                        peak = torch.cuda.max_memory_allocated() - base
                        ms = sm.cuda_ms(torch, run, 3, warm=0)
                except torch.cuda.OutOfMemoryError:
                    parts.append(f"{label}: out of memory")
                    continue
                parts.append(f"{label}: peak {peak / 2**30:.3f} GiB, "
                             f"{ms:.3f} ms")
            print(f"[memory] {name} ({prec}) {f.shape[0]} frames: "
                  + "; ".join(parts) + f" | {card}", flush=True)
            del f
    return 0


if __name__ == "__main__":
    sys.exit(main())
