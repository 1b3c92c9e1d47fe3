"""Requests of filterbank analysis and re-synthesis of long multi-channel
recordings, split in time over the cards: ``ConstantQTransform`` ->
``InverseConstantQTransform``, ``ModifiedDiscreteCosineTransform`` ->
its inverse and ``PseudoQuadratureMirrorFilterBankAnalysis`` -> its
synthesis, summed (chip_smoke.py's ``Battery``, BASELINE.json
configs[4]), each through its sharded class of
``diffsptk_tpu_torch.parallel.filterbanks`` on a (1, cards) mesh.  A call
takes this rank's block of every channel and returns its block of each
output."""

import torch

CHECKS = {"y_gap": "y", "cqt_gap": "cqt", "mdct_gap": "mdct",
          "pqmf_gap": "pqmf"}
"""Each number compared, and the output it compares."""

AXES = {"y": (-1, 1), "cqt": (-2, 64), "mdct": (-2, 128), "pqmf": (-1, 1)}
"""Each output's time axis and the samples a step along it."""


def build(config: dict, device, world: int) -> dict:
    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.filterbanks import (
        ShardedCQT, ShardedICQT, ShardedIMDCT, ShardedIPQMF, ShardedMDCT,
        ShardedPQMF)

    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    p, sr = config["program"], config["sample_rate"]
    mesh = make_mesh((1, world), device_type=device.type)
    kw = dict(device=device, dtype=getattr(torch, config["dtype"]))
    cqt = dict(n_bin=p["cqt_n_bin"], **kw)
    return {
        "dtype": kw["dtype"],
        "cqt": ShardedCQT(mesh, p["cqt_frame_period"], sr, **cqt),
        "icqt": ShardedICQT(mesh, p["cqt_frame_period"], sr, **cqt),
        "mdct": ShardedMDCT(mesh, p["mdct_frame_length"], **kw),
        "imdct": ShardedIMDCT(mesh, p["mdct_frame_length"], **kw),
        "pqmf": ShardedPQMF(mesh, p["pqmf_n_band"], p["pqmf_order"], **kw),
        "ipqmf": ShardedIPQMF(mesh, p["pqmf_n_band"], p["pqmf_order"], **kw),
    }


def call(state: dict, x: torch.Tensor) -> dict:
    x = x.to(state["dtype"])
    c = state["cqt"](x)
    m = state["mdct"](x)
    s = state["pqmf"](x)
    y = state["icqt"](c) + state["imdct"](m) + state["ipqmf"](s)[:, 0, :]
    return {"y": y, "cqt": c, "mdct": m, "pqmf": s}


def spans(state: dict, x: torch.Tensor) -> dict:
    return {"cqt_icqt": lambda: state["icqt"](state["cqt"](x))}


def operations(config: dict, traffic: dict) -> list:
    """No hand-written kernel runs: cuFFT, cuBLAS and cuDNN do the work."""
    return []


def reference(ref, config: dict, x: torch.Tensor, arith) -> dict:
    """The plain battery on a segment of the global signal."""
    return ref.battery(config, x, arith)
