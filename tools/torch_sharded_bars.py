#!/usr/bin/env python3
"""The CPU float32 readings behind chip_smoke.py's SHARDED_BARS.

    python3 tools/torch_sharded_bars.py [ROWS] [--multi N] [--gmm-rows R]
                                        [--gmm-only]
    python3 tools/torch_sharded_bars.py --gmm-witness N [--gmm-rows R]
                                        [--device cuda]
    python3 tools/torch_sharded_bars.py --multi N --device cuda [--gmm-only]

Runs chip_smoke.py's [sharded] pairs (``sharded_cases``: each sharded
class of diffsptk_tpu_torch/parallel/ against the port's one-rank class)
on the CPU in float32, through a gloo process group of world size 1 and a
(1, 1) mesh, on ROWS (default 4) rows of chip_smoke's synthetic speech of
the flagship's 19,200 samples, [battery]'s 76,800-sample rows and the
joint mel-cepstral vectors of R speech rows (default 320: [learners]'
76,800 frames, which the card's GMM fits), and prints each pair's
distance relative to the largest value (``rel_to_max``) beside the bar
it sets: ten times the larger of the one-rank reading and the N-rank one
(``--multi N``: [sharded-multi] on N gloo ranks of the CPU, two rows;
the code the card runs with N cards), and at least ten times float32's
epsilon (float64's for the GMM's float64 fit, ``gmm64``).
``--gmm-only`` runs the GMM's pair alone.

With ``--device cuda`` and ``--multi``, it runs [sharded-multi] alone on
the machine's cards instead (one NCCL rank a card, at chip_smoke.py's
widths), with its checks.

``--gmm-witness N`` runs no ranks: on ``--device`` (default cpu) it fits
the GMM of [sharded] to the R rows at once and in N blocks of rows (the
statistics summed block by block, as N ranks' all-reduce sums them), and
to the rows permuted, each in float32 and in float64 from one float32
start, and prints each fit's leaves (w, mu, sigma, ll) against the
others relative to their max.  The float64 pair shows the N-block sums
equal to the whole sums but for the order of additions; the float32
pairs show how far that order alone moves a float32 fit.
"""

from __future__ import annotations

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gmm_witness(torch, cs, joint, n: int, device) -> None:
    """The GMM fit of [sharded] on ``joint`` at once, in ``n`` blocks and
    with its rows permuted, in float32 and float64, each leaf apart."""
    import diffsptk_tpu_torch as pt

    kw = dict(n_iter=cs.SHARDED_ITERS["gmm"], eps=0, var_type="full",
              block_size=[25, 25], device=device)
    start = pt.GMM(49, 32, dtype=torch.float32, **kw)
    init = (start.w, start.mu, start.sigma)
    perm = torch.randperm(joint.shape[0], generator=torch.Generator(
        ).manual_seed(0)).to(joint.device)

    def fit(x, dtype, blocks=1):
        g = pt.GMM(49, 32, dtype=dtype, batch_size=x.shape[0] // blocks,
                   **kw)
        g.set_params(tuple(p.to(dtype) for p in init))
        (w, mu, sigma), ll = g(x.to(dtype))
        return w, mu, sigma, ll

    with torch.no_grad():
        fits = {(dt, how): fit(joint[perm] if how == "permuted" else joint,
                               dt, n if how == "blocks" else 1)
                for dt in (torch.float32, torch.float64)
                for how in ("whole", "blocks", "permuted")}
    f32, f64 = torch.float32, torch.float64
    for label, a, b in (
            (f"float64, {n} blocks against whole", (f64, "blocks"),
             (f64, "whole")),
            (f"float32, {n} blocks against whole", (f32, "blocks"),
             (f32, "whole")),
            ("float32, rows permuted against whole", (f32, "permuted"),
             (f32, "whole")),
            ("float32 whole against float64", (f32, "whole"),
             (f64, "whole")),
            (f"float32 in {n} blocks against float64", (f32, "blocks"),
             (f64, "whole"))):
        print(f"gmm witness, {joint.shape[0]} rows on {device}, {label} "
              f"(w, mu, sigma, ll): " + ", ".join(
                  f"{v:.3e}" for v in cs.gmm_leaves(torch, fits[a],
                                                     fits[b])),
              flush=True)


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from diffsptk_tpu_torch.parallel import make_mesh

    def option(name, default):
        return (type(default)(argv[argv.index(name) + 1]) if name in argv
                else default)

    rows = int(argv[0]) if argv and argv[0].isdigit() else 4
    multi = option("--multi", 0)
    gmm_rows = option("--gmm-rows", 320)
    device = option("--device", "cpu")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    data = cs.learner_data(torch, gmm_rows, 19200, device)
    joint = cs.sharded_joint(torch, data)
    del data
    if "--gmm-witness" in argv:
        gmm_witness(torch, cs, joint, option("--gmm-witness", 4), device)
        return 0
    names = ("gmm",) if "--gmm-only" in argv else None
    if device == "cuda":
        # [sharded-multi] on this machine's cards at chip_smoke's widths,
        # checked against SHARDED_BARS
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = cs.smi()
        cs.run_sharded_multi(
            torch, torch.as_tensor(cs.synth_speech(32, 19200), device=device),
            torch.as_tensor(cs.synth_speech(8, 76800), device=device), joint,
            card, world=multi or None, names=names or cs.SHARDED_MULTI)
        print(card, flush=True)
        return 0
    # measure, do not judge: the bars are what this prints
    cs.SHARDED_BARS.update({k: float("inf") for k in cs.SHARDED_BARS})
    f32 = torch.float32
    xw = torch.as_tensor(cs.synth_speech(rows, 19200))
    xb = torch.as_tensor(cs.synth_speech(rows, 76800))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh((1, 1), device_type="cpu")
        pairs = cs.sharded_cases(torch, mesh, cs.sharded_inputs(
            torch, xw, xb, joint, "cpu", f32), "cpu", f32)
        with torch.no_grad():
            one = {name: cs.rel_to_max(torch, fn(), ref())
                   for name, (fn, ref) in pairs.items()
                   if names is None or name in names}
    finally:
        dist.destroy_process_group()
    many = (cs.run_sharded_multi(torch, xw[:2], xb[:2], joint, "CPU",
                                 device="cpu", world=multi,
                                 names=names or cs.SHARDED_MULTI)
            if multi else {})
    for name in {**one, **many}:
        dtype = torch.float64 if name.endswith("64") else f32
        worst = max(one.get(name, 0.0), many.get(name, 0.0),
                    float(torch.finfo(dtype).eps))
        print(f"{name}: "
              + (f"one rank {one[name]:.3e}, " if name in one else "")
              + (f"{multi} ranks {many[name]:.3e}, " if name in many else "")
              + f"bar (ten times the larger, at least {dtype}'s eps) "
              f"{10 * worst:.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
