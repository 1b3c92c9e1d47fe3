"""Requests of mel-cepstral copy-synthesis: a batch of waveforms in, the
re-synthesised waveforms out, through
``MelCepstralVocoder.analysis_synthesis`` (STFT, mel-cepstral analysis
with the Newton kernel, the inverse MLSA filter, then the MLSA filter,
both Taylor cascades on the cascade kernel).

The mel-cepstrum that the timed call computed is kept by a forward hook
on the vocoder's analysis module (``voc.mcep``), so both of the call's
results are judged and the window drives the public entry alone.
"""

import torch

CHECKS = {"mc_gap": "mc", "y_gap": "y"}
"""Each number compared, and the output it compares."""


def build(config: dict, device) -> dict:
    import diffsptk_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
    torch.backends.cudnn.allow_tf32 = config["tf32"]
    voc = pt.MelCepstralVocoder(**config["program"], device=device,
                                dtype=getattr(torch, config["dtype"]))
    state = {"voc": voc, "mc": None}

    def keep(module, args, out):
        state["mc"] = out

    voc.mcep.register_forward_hook(keep)
    return state


def call(state: dict, x: torch.Tensor) -> torch.Tensor:
    state["mc"] = None
    return state["voc"].analysis_synthesis(x)


def outputs(state: dict, out: torch.Tensor) -> dict:
    if state["mc"] is None:
        raise RuntimeError("the vocoder's analysis module (voc.mcep) did "
                           "not run in the call")
    return {"mc": state["mc"], "y": out}


def spans(state: dict, x: torch.Tensor) -> dict:
    """The layers timed in the traced run: the analysis, and the MLSA
    synthesis on x as its excitation with the batch's mel-cepstrum (the
    filter's work does not depend on the excitation's values)."""
    voc = state["voc"]
    mc = voc.analyze(x)
    T = mc.shape[-2] * voc.frame_period
    e = x[..., :T].contiguous()
    return {"analysis": lambda: voc.analyze(x),
            "synthesis": lambda: voc.synthesize(e, mc)}


def operations(config: dict, traffic: dict) -> list:
    """(op, sizes) of one call, for ``work/<op>.py``: the Newton solves,
    and the two cascades (inverse, then forward)."""
    p = config["program"]
    B, P = traffic["batch"], p["frame_period"]
    N = (traffic["samples"] - 1) // P + 1
    return [("newton", dict(n=p["cep_order"] + 1, systems=B * N,
                            times=p["n_iter"])),
            ("mlsa_cascade", dict(B=B, N=N, P=P, M=p["cep_order_mlsa"],
                                  S=p["taylor_order"], times=2))]


def reference(ref, config: dict, x: torch.Tensor, arith) -> dict:
    return ref.analysis_synthesis(config, x, arith)
