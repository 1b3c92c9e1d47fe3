"""The plain reference at a small size on the CPU agrees with the program
in float64, for each configuration the cells use."""

import pytest
import torch

from harness import compare, manifest

import diffsptk_tpu_torch as pt


@pytest.mark.parametrize("config,samples", [("mcep16k", 6000),
                                            ("mcep48k", 18000)])
def test_reference_agrees_with_the_program_in_float64(config, samples):
    cfg = manifest.load_json(f"{manifest.BENCH}/configs/{config}.json")
    ref = manifest.module("reference", cfg["reference"])
    gen = torch.Generator().manual_seed(11)
    x = manifest.module("signals", "speech").make(
        gen, 2, samples, cfg["sample_rate"], "cpu").double()
    arith = compare.Arith("float64")
    with arith.scope():
        want = ref.analysis_synthesis(cfg, x, arith)
    voc = pt.MelCepstralVocoder(**cfg["program"], dtype=torch.float64,
                                device="cpu")
    mc = voc.analyze(x)
    y = voc.analysis_synthesis(x)
    assert compare.widest_gap(mc, want["mc"]) < 1e-12
    assert compare.widest_gap(y, want["y"]) < 1e-10
    assert compare.widest_gap(ref.analyze(cfg, x, arith), mc) < 1e-12


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0])
    got = compare.round_tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -10), 3.0])
    assert torch.equal(got, want)
