"""The readings that a cell's limits are set from, on the card at the
cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3

For each seed it makes the cell's first batch as a run does, sends it
through the timed entry (after the run's warm calls) and prints each
number of the entry's ``CHECKS`` against the float64 reference: the
program's readings, whose largest is a limit's lower reading.  For each
control seed it prints the same numbers of the control, the reference
computed in the nearest precision below the configuration's (float32
with TF32 products, ``harness/compare.py``), whose smallest is a limit's
upper reading, and of each fault of ``compare.faults`` planted on the
program's outputs.  One JSON line a reading.  It measures on the card
only, as run.py does.  A cell of several cards runs its ranks once a
seed (``harness/ranks.py``) and reads the same numbers over the windows
that a run compares.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def window_readings(cell, windows, device, control: bool) -> dict:
    """{side: {name: gap}} of a cell of several cards over its compared
    windows: the program's, and with ``control`` the control's and each
    fault's."""
    from harness import compare, manifest, ranks

    entry = manifest.module("entries", cell.traffic["request"], cell.bench)
    ariths = [compare.Arith("float64")]
    if control:
        ariths.append(compare.Arith("tf32"))
    parts: dict = {}
    for x, got, want, *ctl in ranks.compared(cell, windows, device,
                                              *ariths):
        found = (compare.readings(entry.CHECKS, got, want, ctl[0], x)
                 if control else
                 {"program": {name: compare.gap_parts(got[key], want[key])
                              for name, key in entry.CHECKS.items()}})
        for side, p in found.items():
            parts.setdefault(side, []).append(p)
    return {side: compare.pooled(p) for side, p in parts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    import torch

    from harness import compare, manifest

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device(args.device)
    cell = manifest.find(os.getcwd(), args.workload)
    if cell.chips > 1:
        from harness import ranks

        for seed in args.seeds:
            _, out, windows = ranks.collect(
                os.getcwd(), args.workload, seed, 0.0, False, device.type,
                time.perf_counter())
            line = {"workload": args.workload, "seed": seed,
                    "kind": out["device"]["kind"]}
            t0 = time.perf_counter()
            found = window_readings(cell, windows, device,
                                    seed in args.control_seeds)
            line["reference_s"] = time.perf_counter() - t0
            for side, gaps in found.items():
                print(json.dumps({**line, "side": side, **gaps}),
                      flush=True)
        return
    tr, cfg = cell.traffic, cell.config
    entry = manifest.module("entries", tr["request"])
    signal = manifest.module("signals", tr["signal"])
    ref = manifest.module("reference", cfg["reference"])
    f64, tf32 = compare.Arith("float64"), compare.Arith("tf32")
    state = entry.build(cfg, device)
    line = {"workload": args.workload}
    if device.type == "cuda":
        line["kind"] = torch.cuda.get_device_name(device)

    def batch(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return signal.make(gen, tr["batch"], tr["samples"],
                           cfg["sample_rate"], device)

    def gaps(outs, want):
        return {name: compare.widest_gap(outs[key], want[key])
                for name, key in entry.CHECKS.items()}

    with torch.inference_mode():
        x = batch(args.seeds[0])
        for _ in range(tr.get("warm_calls", 2)):
            entry.call(state, x)
        for seed in args.seeds:
            x = batch(seed)
            outs = entry.outputs(state, entry.call(state, x))
            outs = {k: v.clone() for k, v in outs.items()}
            t0 = time.perf_counter()
            with f64.scope():
                want = entry.reference(ref, cfg, x, f64)
            ref_s = time.perf_counter() - t0
            print(json.dumps({**line, "seed": seed, "side": "program",
                              "reference_s": ref_s, **gaps(outs, want)}),
                  flush=True)
            if seed in args.control_seeds:
                with tf32.scope():
                    ctl = entry.reference(ref, cfg, x, tf32)
                found = compare.readings(entry.CHECKS, outs, want, ctl, x)
                for side, parts in list(found.items())[1:]:
                    print(json.dumps({**line, "seed": seed, "side": side,
                                      **{name: err / scale for name,
                                         (err, scale) in parts.items()}}),
                          flush=True)
            del want


if __name__ == "__main__":
    main()
