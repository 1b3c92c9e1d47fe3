"""The port's spans (``diffsptk_tpu_torch/utils/profiling.py``).

On the CPU: off, a round trip of the vocoder enters no
``record_function``, makes no CUDA event, records nothing and computes
what the modules compose to, bit for bit; under ``torch.profiler`` its
spans nest as the layers call each other; off the card no stage time is
recorded; over two spawned gloo ranks the halo exchange's forward and
backward each open one span.  On the card (``gpu``, decided in the
``cuda`` fixture): a stage's device time against CUDA events around the
same call, and the kernel entries' spans.  This file imports no JAX, so
the card runs its ``gpu`` test with

    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py
"""

from __future__ import annotations

import datetime
import multiprocessing
import traceback

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def vocoder():
    return pt.MelCepstralVocoder(cascade="fused", device="cpu",
                                 dtype=torch.float32)


@pytest.fixture
def speech():
    return torch.randn(2, 2400, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(5))


@pytest.fixture(autouse=True)
def no_records():
    profiling.stage_ms(clear=True)
    yield
    profiling.stage_ms(clear=True)


def dsp_tree(prof) -> list:
    """The ``dsp.*`` host ranges of ``prof`` as (depth, name), in order
    of start, each nested under the ranges that hold it."""
    spans = sorted((e for e in prof.events() if e.name.startswith("dsp.")),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    out, open_ends = [], []
    for e in spans:
        while open_ends and open_ends[-1] < e.time_range.end:
            open_ends.pop()
        out.append((len(open_ends), e.name))
        open_ends.append(e.time_range.end)
    return out


def test_off_no_range_no_event_no_record_and_the_same_output(
        vocoder, speech, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered while no profiler records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    y = vocoder.analysis_synthesis(speech)
    assert len(profiling._stages) == 0 and profiling.stage_ms() == {}
    # the round trip as the modules compose it, with no span around it
    with torch.no_grad():
        mc = vocoder.mcep(vocoder.stft(speech))
        T = mc.shape[-2] * vocoder.frame_period
        want = vocoder.mlsa(vocoder.imlsa(speech[..., :T], mc), mc)
    assert torch.equal(y, want)


def test_spans_nest_by_layer_under_the_profiler(vocoder, speech):
    off = vocoder.analysis_synthesis(speech)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = vocoder.analysis_synthesis(speech)
    assert torch.equal(on, off)
    tree = dsp_tree(prof)
    assert tree[0] == (0, "dsp.analysis_synthesis")
    assert all(depth > 0 for depth, _ in tree[1:])
    top = [name for depth, name in tree if depth == 1]
    assert top == ["dsp.analysis", "dsp.synthesis", "dsp.synthesis"]
    at = tree.index((1, "dsp.analysis"))
    under = [name for depth, name in tree[at + 1:tree.index(
        (1, "dsp.synthesis"))] if depth == 2]
    assert under == ["dsp.ShortTimeFourierTransform",
                     "dsp.MelCepstralAnalysis"]
    # every operator call is a span, under the stage that made it
    assert (3, "dsp.Frame") in tree and (3, "dsp.Window") in tree


def test_no_stage_time_off_the_card(vocoder, speech):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vocoder.analyze(speech)
    assert [name for _, name in dsp_tree(prof)][0] == "dsp.analysis"
    assert profiling.stage_ms() == {}


def test_a_span_is_a_context_manager_and_a_decorator():
    with profile(activities=[ProfilerActivity.CPU]):
        @profiling.span("inner")
        def inner(v):
            return v + 1

    @profiling.span("outer")
    def outer(v):
        with profiling.span("block"):
            return inner(v)

    assert outer(1) == 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert outer(2) == 3
    assert dsp_tree(prof) == [(0, "dsp.outer"), (1, "dsp.block"),
                              (2, "dsp.inner")]


def _halo_rank(rank: int, store: str, out) -> None:
    """One of two gloo ranks: the exchange and its backward, each under
    its own profiler; puts (rank, the ``dsp.halo`` ranges of each)."""
    import torch.distributed as dist

    from diffsptk_tpu_torch.parallel import exchange_halo, make_mesh
    from diffsptk_tpu_torch.parallel.mesh import Axis

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        axis = Axis(make_mesh((1, 2), device_type="cpu"), "tp")
        x = torch.randn(3, 12, dtype=torch.float64, requires_grad=True)
        with profile(activities=[ProfilerActivity.CPU]) as forward:
            y = exchange_halo(x, 4, 2, axis)
        with profile(activities=[ProfilerActivity.CPU]) as backward:
            y.backward(torch.ones_like(y))
        out.put((rank, [[e.name for e in prof.events()].count("dsp.halo")
                        for prof in (forward, backward)]))
    except Exception:       # reported to the test, which fails
        out.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def test_exchange_halo_and_its_backward_each_open_one_span(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_halo_rank,
                         args=(rank, str(tmp_path / "store"), out))
             for rank in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert got == {0: [1, 1], 1: [1, 1]}
    assert [p.exitcode for p in procs] == [0, 0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_stage_times_the_device(cuda):
    """Under torch.profiler a stage records its device time:
    ``analyze``'s within 5 % of CUDA events taken around the same call;
    a round trip's kernel entries are spans, one a launch of the Newton
    kernel and one a cascade.  Without a profiler nothing is
    recorded."""
    from chip_smoke import synth_speech

    voc = pt.MelCepstralVocoder(cascade="fused", device=cuda,
                                dtype=torch.float32)
    x = torch.as_tensor(synth_speech(64, 48000), device=cuda,
                        dtype=torch.float32)
    voc.analysis_synthesis(x)
    torch.cuda.synchronize()
    assert profiling.stage_ms() == {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):          # the first warms the profiled path
            profiling.stage_ms(clear=True)
            start.record()
            voc.analyze(x)
            stop.record()
            torch.cuda.synchronize()
    got = profiling.stage_ms(clear=True)
    want = start.elapsed_time(stop)
    assert list(got) == ["analysis"] and len(got["analysis"]) == 1, got
    assert got["analysis"][0] == pytest.approx(want, rel=0.05), (got, want)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        voc.analysis_synthesis(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type != torch.autograd.DeviceType.CUDA]
    assert names.count("dsp.kernel.newton") == 10
    assert names.count("dsp.kernel.mlsa.chunked") == 2
    assert {k: len(v) for k, v in profiling.stage_ms().items()} == {
        "analysis": 1, "synthesis": 1}
