"""Requests of feature extraction: a batch of waveforms in, their
mel-cepstra out, through ``MelCepstralVocoder.analyze`` (STFT, then
mel-cepstral analysis with the Newton kernel).  No cascade runs."""

import torch

CHECKS = {"mc_gap": "mc"}
"""Each number compared, and the output it compares."""


def build(config: dict, device) -> dict:
    import diffsptk_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    return {"voc": pt.MelCepstralVocoder(
        **config["program"], device=device,
        dtype=getattr(torch, config["dtype"]))}


def call(state: dict, x: torch.Tensor) -> torch.Tensor:
    return state["voc"].analyze(x)


def outputs(state: dict, out: torch.Tensor) -> dict:
    return {"mc": out}


def spans(state: dict, x: torch.Tensor) -> dict:
    voc = state["voc"]
    return {"analysis": lambda: voc.analyze(x)}


def operations(config: dict, traffic: dict) -> list:
    p = config["program"]
    N = (traffic["samples"] - 1) // p["frame_period"] + 1
    return [("newton", dict(n=p["cep_order"] + 1,
                            systems=traffic["batch"] * N,
                            times=p["n_iter"]))]


def reference(ref, config: dict, x: torch.Tensor, arith) -> dict:
    return {"mc": ref.analyze(config, x, arith)}
