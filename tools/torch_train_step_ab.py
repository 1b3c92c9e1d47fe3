#!/usr/bin/env python3
"""Time one FCNF0 training step of one checkout of the port, stage by
stage, so that two checkouts can be compared in turns in one run.

    python3 tools/torch_train_step_ab.py [TREE [LABEL]]

TREE (default: this checkout) is the root of a checkout: its
``diffsptk_tpu_torch`` is imported and its ``tools/torch_train_fcnf0.py``
trains, at chip_smoke.py's [train-pitch] shapes (batch 64, TF32, the
device corpus on the threefry kernel), and prints
``chip_smoke.fcnf0_step_split``: for the corpus, the forward and backward,
Adam and the whole step (corpus included), the CUDA-event ms a call over
20 calls after warm-up and the device functions and device-busy ms of one
call (torch.profiler), with the card's name and power limit.  Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    tree = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(tree)
    smoke = _load(os.path.join(HERE, "chip_smoke.py"), "chip_smoke_helpers")
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch.kernels import build
    from diffsptk_tpu_torch.ops.pitch_nn import init_fcnf0_params

    smoke.check(pt.__file__.startswith(tree), f"imported {pt.__file__}")
    TF = _load(os.path.join(tree, "tools", "torch_train_fcnf0.py"),
               "torch_train_fcnf0")
    smoke.check(TF.__file__.startswith(tree), f"loaded {TF.__file__}")
    build.build(("threefry",))
    card = smoke.smi()
    B = 64
    trainer = TF.Trainer(init_fcnf0_params(0), torch.device("cuda"))
    print(f"[{label}] FCNF0 B={B}: "
          + smoke.fcnf0_step_split(torch, TF, trainer, B) + f" | {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
