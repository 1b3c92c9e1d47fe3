"""The measurement helpers of chip_smoke.py that read the cascade kernel's
runs: the grouped-conv1d reference stage, the profiler's busy union and
stage gaps, and ptxas' register summary; and the pitch networks' FLOP
count; on the CPU."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import chip_smoke
from diffsptk_tpu_torch.kernels.mlsa_cascade import taylor_cascade_direct


def _event(name, start, end):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end))


def test_conv_stage_is_one_direct_stage():
    """Its grouped F.conv1d and lerp compute one stage of the cascade."""
    P, M = 16, 23
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((2, 5 * P)))
    c = torch.as_tensor(rng.standard_normal((2, 5, M + 1)) * 0.3)
    got = chip_smoke.conv_stage(torch, x, c, P, M)()
    want = taylor_cascade_direct(x, c, torch.ones(2, dtype=x.dtype),
                                 torch.tensor([0.0, 1.0], dtype=x.dtype), P,
                                 0)
    np.testing.assert_allclose(got.reshape(2, -1).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_busy_union_and_stage_gaps():
    """Overlapping stages (programmatic launches) count once as busy, and
    their gaps are negative; an idle gap counts towards the share."""
    events = [_event("stage_kernel<true>", 0.0, 10.0),
              _event("stage_kernel<true>", 8.0, 22.0),
              _event("gemm", 23.0, 30.0),
              _event("stage_kernel<true>", 31.0, 40.0),
              _event("stage_kernel<true>", 41.0, 50.0)]
    assert chip_smoke.union_us(events) == 47.0
    line = chip_smoke.stage_gaps(events)
    assert line.startswith("2 gaps between cascade stages, median -0.50 us")
    assert "idle 1.00 us in all, 2.4 %" in line
    assert chip_smoke.stage_gaps(events[2:3]) == (
        "no back-to-back cascade stages")
    # two cascades of two stages, back to back: the host's gap between
    # them is not one between stages
    calls = [_event("stage_kernel<true>", 0.0, 10.0),
             _event("stage_kernel<true>", 11.0, 20.0),
             _event("stage_kernel<true>", 50.0, 60.0),
             _event("stage_kernel<true>", 62.0, 70.0)]
    assert chip_smoke.stage_gaps(calls).startswith(
        "3 gaps between cascade stages, median 2.00 us, idle 33.00 us")
    assert chip_smoke.stage_gaps(calls, stages=2).startswith(
        "2 gaps between cascade stages, median 1.50 us, idle 3.00 us")


def test_ptxas_summary_reads_each_instance():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112stage_kernelILb1EEEvPKf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112stage_kernelILb0EEEvPKf' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 63 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 12 registers"])
    summary = chip_smoke.ptxas_summary(log, "stage_kernel")
    assert summary.count("float4:") == 2 and summary.count("scalar:") == 2
    assert "Used 64 registers" in summary and "8 bytes spill" in summary
    assert "12 registers" not in summary
    assert chip_smoke.ptxas_summary("", "stage_kernel") == (
        "not in the build log")


def test_ptxas_usage_reads_template_instances():
    """One entry per instance, keyed by its integer template argument;
    spills are the stores and loads together."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113newton_kernelILi25EEEvPKfS2_Pfi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 30000 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113newton_kernelILi33EEEvPKfS2_Pfi' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 12 registers"])
    usage = chip_smoke.ptxas_usage(log, "newton_kernel")
    assert usage == {25: [72, 0], 33: [128, 12]}
    line = chip_smoke.usage_line(usage, pick=25)
    assert line == ("2 instances, 72-128 registers, 12 bytes spilled "
                    "(n=25: 72 registers, 0 bytes spilled)")
    one = chip_smoke.ptxas_usage(log.replace("newton", "gather"),
                                 "gather_kernel")
    assert len(one) == 2
    assert chip_smoke.usage_line({}) == "not in the build log"


def test_rate_reports_unmeasured_device_time():
    """A device time the profiler did not record reads "not measured",
    never a rate from a zero time."""
    assert chip_smoke.device_rate(3.35e9, 0.0, 1.0) == "not measured"
    assert chip_smoke.device_rate(3.35e9, 2.0, 1.0) == (
        "2.0000 ms, 1.675 TB/s, 50.0 % of the bound")


def test_busy_share_reads_one_window_unclamped(monkeypatch):
    """The share is the busy time over the same calls' elapsed time, as
    measured: never clamped to 100 %; with it, how many profiler windows
    so far were profiled twice."""
    monkeypatch.setattr(chip_smoke, "PROFILED", {"windows": 7, "again": 1})
    assert chip_smoke.busy_share(2.0, 4.0) == (
        "device busy 2.000 ms of 4.000 ms elapsed in the same profiled "
        "calls (50.0 %; 1 of 7 profiler windows so far profiled twice)")
    assert "(102.5 %;" in chip_smoke.busy_share(4.1, 4.0)


@pytest.mark.parametrize("algo", ["fcnf0", "crepe"])
def test_conv_flops_counts_every_layer(monkeypatch, algo):
    """conv_flops' layer plan equals the multiply-adds of the convs (and
    CREPE's classifier) that one frame really runs through the port."""
    from diffsptk_tpu_torch.ops import pitch_nn as nn_

    macs = []
    conv = nn_.conv

    def counted(h, w, b=None, stride=1, precision="full"):
        y = conv(h, w, b, stride=stride, precision=precision)
        macs.append(w.shape[0] * w.shape[1] * w.shape[2] * y.shape[-1])
        return y

    monkeypatch.setattr(nn_, "conv", counted)
    x = torch.randn(1, 1024)
    if algo == "fcnf0":
        nn_.fcnf0_forward(nn_.init_fcnf0_params(), x)
    else:
        nn_.crepe_forward(nn_.init_crepe_params("tiny"), x, "tiny")
        macs.append(nn_.CREPE_PITCH_BINS * 256)      # the classifier
    assert chip_smoke.conv_flops(algo, "tiny") == 2.0 * sum(macs)



def test_battery_is_bench_alls_battery():
    """chip_smoke.Battery at float64 on the CPU against bench_all.py's
    battery as the JAX package computes it, on its 8 channels of 4,096
    samples (rtol 1e-5 / atol 1e-8)."""
    import jax.numpy as jnp

    import diffsptk_tpu as dsp

    x = np.random.default_rng(9).standard_normal((8, 4096))
    T = x.shape[-1]
    xj = jnp.asarray(x)
    want = (dsp.ICQT(64, 16000, n_bin=24)(dsp.CQT(64, 16000, n_bin=24)(xj),
                                          out_length=T)
            + dsp.IMDCT(256)(dsp.MDCT(256)(xj), out_length=T)
            + dsp.IPQMF(4, 47)(dsp.PQMF(4, 47)(xj))[..., 0, :T])
    got = chip_smoke.Battery("cpu", torch.float64)(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-8)


def test_battery_stage_bounds_count_the_work(monkeypatch):
    """Each stage's bound from its shapes: the time-basis overlap-add's
    operations (two octaves of 2 x 24 x 8,192 per frame) and the PQMF
    pair's (2 x 48 taps x 4 bands per sample, each way)."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda torch, fn, iters, warm: 0.0)
    C, T = 2, 7680
    bat = chip_smoke.Battery("cpu", torch.float32)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((C, T)),
                        dtype=torch.float32)
    stages = chip_smoke.battery_stages(torch, bat, x)
    n = T // 64
    ms, bound, by = stages["time-basis overlap-add"]
    assert ms == 0.0 and by == "operations"
    assert bound == pytest.approx(
        2 * (2 * C * n * 24 * 8192) / chip_smoke.F32_PEAK * 1e3)
    assert stages["pqmf convs"][1] == pytest.approx(max(
        2 * (2 * C * 4 * T * 48) / chip_smoke.F32_PEAK * 1e3,
        4 * (C * T + C * 4 * T + 4 * 48 + C * 4 * T + C * T + 4 * 48)
        / chip_smoke.HBM_RATE * 1e3))
    assert all(v[1] > 0 for v in stages.values())


def test_profile_chain_profiles_an_empty_window_once_more(monkeypatch,
                                                          capsys):
    """A window with no device activity recorded is profiled once more,
    with a note; a second empty window reads as no device function, so a
    check on the count still fails.  ``PROFILED`` counts the windows and
    the second attempts."""
    import torch.profiler

    cuda = torch.autograd.DeviceType.CUDA
    traces = []

    class FakeProfile:
        def __init__(self, activities):
            self.trace = traces.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.trace

    def kernel(start):
        return types.SimpleNamespace(
            name="scan_kernel", device_type=cuda, device_time=4.0,
            time_range=types.SimpleNamespace(start=start, end=start + 4.0))

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "PROFILED", {"windows": 0, "again": 0})
    traces[:] = [[kernel(0.0)], [], [kernel(0.0), kernel(10.0)]]
    chip_smoke.profile_chain(torch, lambda: None, calls=1)
    assert chip_smoke.PROFILED == {"windows": 1, "again": 0}
    busy, top, n_device, _, _ = chip_smoke.profile_chain(
        torch, lambda: None, calls=2)
    assert n_device == 1 and busy == pytest.approx(0.004)
    assert top == [("scan_kernel", pytest.approx(0.004))]
    assert chip_smoke.PROFILED == {"windows": 2, "again": 1}
    assert ("profiling them once more (1 of 2 profiler windows so far "
            "profiled twice)") in capsys.readouterr().out
    traces[:] = [[], []]
    assert chip_smoke.profile_chain(torch, lambda: None, calls=2)[2] == 0
    assert chip_smoke.PROFILED == {"windows": 3, "again": 2}


def test_analysis_rest_errors_per_frame_and_roots_as_sets():
    """Each frame's max error over the reference's max; roots compared
    as sets, so their order does not count; NaN stays NaN (a frame that
    no bar admits)."""
    ref = {"lpc2par": torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
           "roots-aberth": torch.tensor([[1 + 1j, 2 - 1j, 3 + 0j]])}
    out = {"lpc2par": torch.tensor([[1.0, 2.4], [3.0, float("nan")]]),
           "roots-aberth": torch.tensor([[3 + 0j, 1 + 1j, 2 - 1.5j]])}
    errs = chip_smoke.analysis_rest_errors(out, ref)
    assert errs["lpc2par"][0] == pytest.approx(0.1)
    assert torch.isnan(errs["lpc2par"][1])
    assert errs["roots-aberth"].tolist() == pytest.approx([0.5 / 3])


def test_mgc_chain_inverts_its_filter():
    """The [mgc] chain's excitation goes through the MGLSA filter at
    -gamma on -mgc, the exact inverse (a round trip above 15 dB on 1,600
    samples at float64; the reference's pseudo inverse stays below 0)."""
    x = torch.as_tensor(chip_smoke.synth_speech(1, 1600)).double()
    mgc, e, y = chip_smoke.mgc_chain(torch, "cpu", torch.float64)[0](x)
    assert mgc.shape == (1, 20, 25) and y.shape == x.shape
    snr = 10 * torch.log10((x ** 2).sum() / ((y - x) ** 2).sum())
    assert float(snr) > 15.0


@pytest.fixture(scope="module")
def speech_row():
    """Row 0 of the smoke's signal and its power spectrum, float32."""
    xs = torch.as_tensor(chip_smoke.synth_speech(1, 19200))
    return xs, chip_smoke.power_spectrum(torch, xs)


def _rel(got, want):
    got = got.to(want.dtype)
    return float((got - want).abs().max() / want.abs().max())


def test_feature_and_gammatone_bars_hold_on_the_cpu(speech_row):
    """The CPU float32 readings that FEATURE_BARS and GAMMATONE_BARS are
    ten times (rounded up), against float64 on the same inputs."""
    import diffsptk_tpu_torch as pt

    xs, sp = speech_row
    ops = chip_smoke.feature_ops(torch, "cpu", torch.float32)
    ops64 = chip_smoke.feature_ops(torch, "cpu", torch.float64)
    for name, bar in chip_smoke.FEATURE_BARS.items():
        assert _rel(ops[name](sp), ops64[name](sp.double())) <= bar / 10
    f32 = dict(device="cpu", dtype=torch.float32)
    f64 = dict(device="cpu", dtype=torch.float64)
    sub = pt.GammatoneFilterBankAnalysis(16000, **f32)(xs)
    sub64 = pt.GammatoneFilterBankAnalysis(16000, **f64)(xs.double())
    y = pt.GammatoneFilterBankSynthesis(16000, **f32)(sub)
    y64 = pt.GammatoneFilterBankSynthesis(16000, **f64)(sub64)
    bars = chip_smoke.GAMMATONE_BARS
    assert _rel(sub, sub64) <= bars["analysis"] / 10
    assert _rel(y, y64) <= bars["synthesis"] / 10
    inner = slice(800, 19200 - 800)
    assert chip_smoke.snr_db(torch, xs[:, inner],
                             y[:, 0, inner]) > chip_smoke.GAMMATONE_SNR


def test_ops_rest_bars_hold_on_the_cpu(speech_row):
    """Each [ops-rest] module's CPU float32 reading against float64 on the
    same inputs lies within a tenth of its bar (within the bar for the
    quantizer and the exact dequantizer, whose readings are 0), and
    every module has a bar but the named host step."""
    xs, sp = speech_row
    feats = chip_smoke.feature_ops(torch, "cpu", torch.float32)
    frames = sp.shape[-2]
    ops = chip_smoke.ops_rest_ops(torch, "cpu", torch.float32, frames)
    ops64 = chip_smoke.ops_rest_ops(torch, "cpu", torch.float64, frames)
    plp = feats["plp24"](torch.cat((sp, sp.flip(-2))))
    inputs = chip_smoke.ops_rest_inputs(torch, ops, xs, sp,
                                        feats["mfcc"](sp), plp)
    assert set(ops) - set(chip_smoke.OPS_REST_BARS) == set(
        chip_smoke.OPS_REST_HOST_STEPS)
    for name, bar in chip_smoke.OPS_REST_BARS.items():
        args = chip_smoke.row0(name, inputs[name])
        got = ops[name](*args)
        want = ops64[name](*(a.double() for a in args))
        exact = name in ("quantize", "dequantize")
        assert _rel(got, want) <= (bar if exact else bar / 10), name


def test_spectral_convergence_of_the_signal_itself():
    import diffsptk_tpu_torch as pt

    xs = torch.as_tensor(chip_smoke.synth_speech(1, 3200), dtype=torch.float64)
    stft = pt.STFT(400, 80, 512, out_format="complex", device="cpu",
                   dtype=torch.float64)
    s = stft(xs).abs()
    assert chip_smoke.spectral_convergence(torch, stft, s, xs) < 1e-12
    assert chip_smoke.spectral_convergence(torch, stft, s, 0 * xs) == 1.0


def test_rel_to_max_holds_nans_to_their_places():
    """NaNs at the same places are left out of the comparison; NaNs in
    different places, or a leaf of another count, do not pass."""
    w = torch.tensor([1.0, float("nan"), -4.0], dtype=torch.float64)
    assert chip_smoke.rel_to_max(torch, w + 1e-3, w) == pytest.approx(2.5e-4)
    assert np.isnan(chip_smoke.rel_to_max(
        torch, torch.tensor([1.0, 2.0, float("nan")], dtype=torch.float64),
        w))
    assert chip_smoke.rel_to_max(torch, (w, w[:2]), (w, w[:2])) == 0.0
    with pytest.raises(ValueError):
        chip_smoke.rel_to_max(torch, (w,), (w, w))


def test_class_path_runs_the_operator_once():
    """The class path stops the functional call at its operator, builds
    the operator afresh and runs it alone: equal to the functional call,
    one operator run; a function with no operator returns its own
    result."""
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu_torch import functional as F

    x = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 8)))
    runs = []
    forward = pt.DiscreteCosineTransform.forward

    def counted(self, *a, **kw):
        runs.append(1)
        return forward(self, *a, **kw)

    pt.DiscreteCosineTransform.forward = counted
    try:
        want = F.dct(x)
        runs.clear()
        got = chip_smoke.class_path(torch, F.dct, (x,), {})
    finally:
        pt.DiscreteCosineTransform.forward = forward
    assert len(runs) == 1
    assert torch.equal(got, want)
    path = torch.as_tensor([[0, 0], [1, 1]])
    y = torch.ones(2, 1, dtype=torch.float64)
    assert torch.equal(chip_smoke.class_path(torch, F.dtw_merge,
                                             (y, y, path), {}),
                       F.dtw_merge(y, y, path))
