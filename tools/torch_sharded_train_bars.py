#!/usr/bin/env python3
"""The CPU float32 readings behind chip_smoke.py's SHARDED_TRAIN_BARS, and
[sharded-train]'s n-card check alone.

    python3 tools/torch_sharded_train_bars.py
    python3 tools/torch_sharded_train_bars.py --multi N

Without ``--multi``: ``DryrunStep`` (diffsptk_tpu_torch/parallel/train.py)
through a gloo process group of world size 1 on a (1, 1) mesh on the
CPU, from the first 2 rows of [sharded-train]'s input (``dryrun_inputs``
at 32 x 19,200, float32) with ``stable_lpc``'s coefficients, once in
float32 and once in float64 on the same values, the float64 step's WORLD
replaying the float32 step's noise (``NoiseTape``: the two dtypes' JAX
streams draw different numbers): the loss, its WORLD term and the
gradients of window, mc and lpc of the float32 step against the float64
one, relative to the float64 leaf's max (``rel_to_max``), each beside
the bar it sets, ten times the reading (at least ten times float32's
epsilon).

With ``--multi N``: ``run_sharded_train_multi`` alone on the machine's
cards, one NCCL rank a card on the dryrun's mesh for N, against one card
on the same input, checked against SHARDED_TRAIN_BARS.
"""

from __future__ import annotations

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS = 2


def main(argv) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from diffsptk_tpu_torch.ops import world_common as wc
    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.train import DryrunStep, dryrun_inputs

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    if "--multi" in argv:
        card = cs.smi()
        cs.run_sharded_train_multi(torch, card,
                                   world=int(argv[argv.index("--multi") + 1]))
        print(card, flush=True)
        return 0
    inputs = {k: v[:ROWS] for k, v in dryrun_inputs(
        cs.SHARDED_TRAIN_B, cs.SHARDED_TRAIN_T, np.float32).items()}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh((1, 1), device_type="cpu")
        out, tape = {}, None
        for dtype in (torch.float32, torch.float64):
            step = DryrunStep(mesh, device="cpu", dtype=dtype)
            npd = np.float32 if dtype == torch.float32 else np.float64
            cast = {k: v.astype(npd) for k, v in inputs.items()}
            params = cs.train_pytree(step, cast, True)
            if tape is None:
                tape = cs.NoiseTape(torch, wc, step.world.synth)
                undo = tape.record()
            else:
                # both steps start from the float32 window's values and
                # draw the float32 step's noise
                params["window"] = {"window": out["params"]["window"][
                    "window"].astype(npd)}
                undo = tape.replay(step.world.synth, rows=ROWS)
            out.setdefault("params", params)
            try:
                out[dtype] = cs.train_grads(step, params, *step.blocks(cast))
            finally:
                undo()
    finally:
        dist.destroy_process_group()
    errs = cs.train_errs(torch, out[torch.float32], out[torch.float64])
    eps = float(torch.finfo(torch.float32).eps)
    for k, v in errs.items():
        print(f"{k}: float32 against float64 on {ROWS} rows of "
              f"{cs.SHARDED_TRAIN_T} {v:.3e}, bar (ten times, at least ten "
              f"times float32's eps) {10 * max(v, eps):.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
