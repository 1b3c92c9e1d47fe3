"""The port's CUDA kernels against their plain twins on the card.

Marked ``gpu``; without a card every test skips (decided in the
``cuda`` fixture).  Runs on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest imports JAX, which the
port's machine need not have).  This file imports no JAX.

Tolerances: the Newton kernel within 2e-4 (rtol and atol) of its twin,
the mcep residual kernel within RESIDUAL_BAR of float64 (of max|rt|),
its backward within 1e-4 of max|grad| of autograd through the twin,
the cascade kernel (both entries) within 1e-5 of max|y| of the folded
twin and of the direct plain version (fp32 arithmetic in another order
than the twin's matmuls and the direct version's sums); the tensor-core
cascade (both entries, HIGH and DEFAULT) within ``TC_BARS`` of its twin
in the same arithmetic, equal to itself replayed in a CUDA graph; the windowed
gather equal to
its twin (a copy); the overlap-add and the gather's backward within 1e-5
of their twins (sums in another order than index_add's), and the
overlap-add equal to overlap_add_grouped (its own order, in torch); the
threefry kernel's bits and normals equal to its twin's bit for bit (both
copy XLA CPU's float32 log1p and its fused multiply-adds); the SPD solve kernel within
1e-4 of max|x| of its twin, its backward rtol 1e-3 / atol 1e-4; the scan kernel
within 2e-5 (float32) and 1e-4 (complex64) of its twin, its backward
within 1e-4 (the tolerances of tests/test_pallas_scan.py), and equal bit
for bit to itself: run twice, and replayed in a CUDA graph.  The
filterbanks (no kernel of their own) float32 on the card against the
port's float64 on the CPU: CQT and ICQT within 1e-3 of max, the others
1e-4; mc2b, b2mc, mgc2sp and Hilbert 1e-5, the all-zero filter's FFT
path 1e-5; the vocoder's modes within the flagship's 1e-2 of max|y|.
The speech-feature front end, gammatone and the small signal ops float32
on the card against float64 on the CPU within chip_smoke.py's bars
(FEATURE_BARS, GAMMATONE_BARS, OPS_REST_BARS); the eig roots equal to
the CPU's (one host computation).  The misc ops within MISC_BARS and with
no host read; two LBG runs on the card equal (integer counts and a one-hot
GEMM for the centroid sums); the stateless functions' kernel launches;
the median filter beyond torch.quantile's 2^24 elements equal to the CPU's
run in chunks of the batch; the multi-chip training step (parallel/train.py)
within SHARDED_TRAIN_BARS of its float64 run on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from chip_smoke import (
    FEATURE_BARS,
    GAMMATONE_BARS,
    MISC_BARS,
    OPS_REST_BARS,
    OPS_REST_HOST_STEPS,
    SHARDED_BARS,
    SHARDED_LAUNCHES,
    f0_tracks,
    feature_ops,
    class_path,
    functional_kernel_rows,
    misc_inputs,
    misc_ops,
    ops_rest_inputs,
    ops_rest_ops,
    power_spectrum,
    rel_to_max,
    row0,
    synth_speech,
)
from diffsptk_tpu_torch.kernels import (
    gather,
    mcep_residual,
    mlsa,
    newton,
    ola,
    scan,
    solve,
    threefry,
)
from diffsptk_tpu_torch.kernels.mlsa_cascade import (
    chunked_geometry,
    lane_aligned_nfft,
    taylor_cascade_chunked,
    taylor_cascade_direct,
    taylor_cascade_folded,
    taylor_cascade_unchunked,
)
from diffsptk_tpu_torch.utils import prng

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _system(n, B, seed=0):
    rng = np.random.default_rng(seed)
    rt = rng.standard_normal((2 * n - 1, B)).astype(np.float32) * 0.1
    rt[0] += 4.0 + n * 0.2
    b = rng.standard_normal((n, B)).astype(np.float32)
    return rt, b


@pytest.mark.parametrize("n,B", [(1, 5), (2, 9), (6, 100), (25, 7680),
                                 (25, 7683), (31, 70), (32, 77), (33, 70),
                                 (33, 1001)])
def test_newton_kernel_matches_twin(cuda, n, B):
    """Every lane a row at n = 32, lane 0 two rows at n = 33; B not a
    multiple of a block's 4 systems."""
    rt, b = (torch.as_tensor(a, device=cuda) for a in _system(n, B))
    before = newton.launches
    x = newton.newton_solve_lane_major(rt, b)
    assert newton.launches == before + 1
    torch.testing.assert_close(x, newton.newton_solve_plain(rt, b),
                               rtol=2e-4, atol=2e-4)


def test_newton_kernel_backward(cuda):
    rt, b = (torch.as_tensor(a, device=cuda).requires_grad_(True)
             for a in _system(25, 300, seed=1))
    newton.newton_solve_t(rt, b).sin().sum().backward()
    grads = rt.grad.clone(), b.grad.clone()
    rt.grad = b.grad = None
    with pt.twins():
        newton.newton_solve_t(rt, b).sin().sum().backward()
    torch.testing.assert_close(grads[0], rt.grad, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(grads[1], b.grad, rtol=2e-4, atol=2e-4)


def test_newton_kernel_rejects(cuda):
    rt, b = (torch.as_tensor(a, device=cuda) for a in _system(6, 10))
    with pytest.raises(TypeError):
        newton.newton_solve_lane_major(rt.double(), b.double())
    with pytest.raises(ValueError):
        newton.newton_solve_lane_major(rt.T.contiguous().T, b)
    rt, b = (torch.as_tensor(a, device=cuda) for a in _system(34, 10))
    with pytest.raises(ValueError):
        newton.newton_solve_lane_major(rt, b)


def _toephank(n, B, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, B)).astype(np.float32) * 0.1
    p[0] += 4.0 + n * 0.2
    q = rng.standard_normal((2 * n - 1, B)).astype(np.float32) * 0.1
    b = rng.standard_normal((n, B)).astype(np.float32)
    return p, q, b


@pytest.mark.parametrize("n,B", [(1, 5), (12, 2049), (24, 7680), (24, 7683),
                                 (33, 70)])
def test_toephank_kernel_matches_twin(cuda, n, B):
    """The two-generator entry (mgcep's systems), B not a multiple of a
    block's 4 systems."""
    p, q, b = (torch.as_tensor(a, device=cuda) for a in _toephank(n, B))
    before = newton.launches, newton.launches_toephank
    x = newton.toephank_solve_lane_major(p, q, b)
    assert (newton.launches, newton.launches_toephank) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(x, newton.toephank_solve_plain(p, q, b),
                               rtol=2e-4, atol=2e-4)


def test_toephank_kernel_backward(cuda):
    p, q, b = (torch.as_tensor(a.T.copy(), device=cuda).requires_grad_(True)
               for a in _toephank(24, 300, seed=1))
    newton.toephank_solve(p, q, b).sin().sum().backward()
    grads = p.grad.clone(), q.grad.clone(), b.grad.clone()
    p.grad = q.grad = b.grad = None
    with pt.twins():
        newton.toephank_solve(p, q, b).sin().sum().backward()
    for got, want in zip(grads, (p.grad, q.grad, b.grad)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_mgcep_takes_the_two_generator_kernel(cuda):
    """mgcep at gamma = -1/3 on the card: 1 + n_iter two-generator
    launches, float32 within 1e-3 of max of float64 on the CPU."""
    sp = pt.STFT(400, 80, 512, eps=0, relative_floor=-80, out_format="power",
                 device="cpu", dtype=torch.float64)(
        torch.as_tensor(synth_speech(2, 3200)))
    kw = dict(fft_length=512, cep_order=24, alpha=0.42, c=3, n_iter=3)
    op = pt.MelGeneralizedCepstralAnalysis(**kw, device=cuda,
                                           dtype=torch.float32)
    newton.launches = newton.launches_toephank = 0
    got = op(sp.float().to(cuda))
    torch.cuda.synchronize()
    assert (newton.launches, newton.launches_toephank) == (4, 4)
    want = pt.MelGeneralizedCepstralAnalysis(**kw, device="cpu",
                                             dtype=torch.float64)(sp)
    assert _rel(got, want) <= 1e-3


def _cascade_case(cuda, B, N, P, M, S, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((B, N * P)), dtype=torch.float32,
                        device=cuda)
    base = rng.standard_normal((B, 1, M + 1)) * (0.8 ** np.arange(M + 1))
    c = torch.as_tensor(
        base * (1 + 0.05 * rng.standard_normal((B, N, M + 1))) * 0.3,
        dtype=torch.float32, device=cuda)
    weights = torch.as_tensor(
        1.0 / np.cumprod([1.0] + list(range(1, S + 1))), dtype=torch.float32,
        device=cuda)
    a = torch.ones(S + 1, dtype=torch.float32, device=cuda)
    return x, c, weights, a


def _assert_cascade_close(y, want):
    err = float((y - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("B,N,P,M,S,advance", [(2, 7, 16, 39, 4, 0),
                                               (3, 40, 80, 199, 5, 0),
                                               (1, 9, 16, 30, 3, 5),
                                               (2, 30, 18, 50, 3, 0),
                                               (1, 12, 16, 239, 3, 0)])
def test_cascade_kernel_matches_twin(cuda, B, N, P, M, S, advance):
    """Tile edges, the last-row blend, P not a multiple of 4, Q up to
    15."""
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S)
    nfft_c = lane_aligned_nfft(3 * P)
    before = mlsa.launches
    y = mlsa.cascade_chunked_cuda(x.reshape(B, N, P), c, weights, a, P,
                                  advance, nfft_c)
    assert mlsa.launches == before + S
    want = taylor_cascade_chunked(x, c, weights, a, P, advance, nfft_c)
    _assert_cascade_close(y.reshape(B, N * P), want)


@pytest.mark.parametrize("j", [0, 1, 2])
def test_cascade_kernel_each_chunk(cuda, j):
    """Coefficients in tap chunk j only, at the flagship P and M: the
    decaying coefficients of the cases above leave chunks 1 and 2 near
    zero at P=80."""
    B, N, P, M, S = 2, 50, 80, 199, 20
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=4)
    lo, hi = j * P, min((j + 1) * P, M + 1)
    c = torch.zeros_like(c)
    c[..., lo:hi] = torch.as_tensor(
        np.random.default_rng(j).standard_normal((B, N, hi - lo)) * 0.02,
        dtype=torch.float32, device=cuda)
    nfft_c = lane_aligned_nfft(3 * P)
    y = mlsa.cascade_chunked_cuda(x.reshape(B, N, P), c, weights, a, P, 0,
                                  nfft_c)
    want = taylor_cascade_chunked(x, c, weights, a, P, 0, nfft_c)
    _assert_cascade_close(y.reshape(B, N * P), want)


def test_cascade_entry_takes_the_kernel(cuda):
    B, N, P, M, S = 2, 50, 80, 199, 20
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=3)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    assert chunked_geometry(M, P, nfft) is not None
    before = mlsa.launches
    y = mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft)
    assert mlsa.launches == before + S
    _assert_cascade_close(y, taylor_cascade_folded(x, c, weights, a, P, 0,
                                                   nfft))
    with pytest.raises(TypeError):
        mlsa.taylor_cascade(x.double(), c.double(), weights.double(),
                            a.double(), P, 0, nfft)


def test_vocoder_runs_both_kernels(cuda):
    voc = pt.MelCepstralVocoder(cascade="fused", device=cuda,
                                dtype=torch.float32)
    x = torch.randn(2, 3200, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))
    newton.launches = mlsa.launches = 0
    y = voc.analysis_synthesis(x)
    assert newton.launches == 10 and mlsa.launches == 40
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_vocoder_float64_takes_the_plain_paths(cuda):
    """The kernels take float32; a float64 chain on the card runs the
    non-kernel branches, as the JAX package does off the TPU."""
    voc = pt.MelCepstralVocoder(cascade="fused", device=cuda,
                                dtype=torch.float64)
    x = torch.randn(1, 1600, device=cuda, dtype=torch.float64,
                    generator=torch.Generator(cuda).manual_seed(1))
    newton.launches = mlsa.launches = 0
    y = voc.analysis_synthesis(x)
    assert newton.launches == 0 and mlsa.launches == 0
    assert torch.isfinite(y).all()


def _f32(cuda, seed=None):
    """float32 on the card (whatever torch's default dtype), with a
    seeded generator when ``seed`` is given."""
    kw = dict(device=cuda, dtype=torch.float32)
    if seed is not None:
        kw["generator"] = torch.Generator(cuda).manual_seed(seed)
    return kw


def _spd(cuda, batch, n, seed=0):
    kw = _f32(cuda, seed)
    M = torch.randn(batch, n, n, **kw)
    A = M @ M.transpose(-1, -2) + n * torch.eye(n, **_f32(cuda))
    return A, torch.randn(batch, n, **kw)


@pytest.mark.parametrize("n,B", [(1, 5), (13, 2048), (24, 7680), (33, 300),
                                 (64, 2050), (8, 301), (9, 301), (16, 302),
                                 (17, 302), (25, 303), (32, 303), (40, 129),
                                 (63, 131)])
def test_spd_solve_kernel_matches_twin(cuda, n, B):
    """Each order the kernel has an instance for (multiples of 8) and the
    orders just past one, which it pads with the identity."""
    A, b = _spd(cuda, B, n)
    before = solve.launches
    x = solve.spd_solve_batched(A, b)
    assert solve.launches == before + 1
    want = solve.spd_solve_plain(A, b)
    assert float((x - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_spd_solve_kernel_backward(cuda):
    A, b = _spd(cuda, 2048, 24, seed=1)
    A.requires_grad_(True)
    b.requires_grad_(True)
    before = solve.launches
    solve.spd_solve_diff(A, b).sin().sum().backward()
    assert solve.launches == before + 2
    grads = A.grad + A.grad.transpose(-1, -2), b.grad.clone()
    A.grad = b.grad = None
    with pt.twins():
        solve.spd_solve_diff(A, b).sin().sum().backward()
    torch.testing.assert_close(grads[0], A.grad + A.grad.transpose(-1, -2),
                               rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(grads[1], b.grad, rtol=1e-3, atol=1e-4)


def test_spd_solve_kernel_rejects(cuda):
    A, b = _spd(cuda, 4, 65)
    with pytest.raises(ValueError):
        solve.spd_solve_batched(A, b)
    with pytest.raises(TypeError):
        solve.spd_solve_batched(A[:, :8, :8].double(), b[:, :8].double())


def test_spd_solve_kernel_indefinite_gives_nan(cuda):
    A = torch.eye(16, **_f32(cuda)).repeat(3, 1, 1)
    A[:, 0, 0] = -1.0
    x = solve.spd_solve_batched(A, torch.ones(3, 16, **_f32(cuda)))
    assert torch.isnan(x[:, 0]).all()


def _scan_case(cuda, shape, complex_, seed=0):
    kw = _f32(cuda, seed)
    p = 0.9 * (2 * torch.rand(shape, **kw) - 1)
    x = torch.randn(shape, **kw)
    if complex_:
        p = p * torch.exp(1j * 6.28 * torch.rand(shape, **kw))
        x = torch.complex(x, torch.randn(shape, **kw))
    return p, x


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("shape", [(32, 19200), (3, 1), (5, 1023),
                                   (2, 1025), (1, 1100000), (4, 3, 777)])
def test_scan_kernel_matches_twin(cuda, shape, complex_):
    """One chunk, a ragged last chunk, and rows of more than 1,024 chunks
    (a second level of summaries)."""
    p, x = _scan_case(cuda, shape, complex_)
    before = scan.launches
    y = scan.first_order_scan(p, x)
    assert scan.launches == before + 1
    tol = 1e-4 if complex_ else 2e-5
    torch.testing.assert_close(y, scan.first_order_scan_plain(p, x),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("complex_", [False, True])
def test_scan_kernel_backward(cuda, complex_):
    p, x = _scan_case(cuda, (4, 3000), complex_, seed=2)
    p.requires_grad_(True)
    x.requires_grad_(True)

    def loss():
        y = scan.scan_diff(p, x)
        return (y.real.sin() + y.imag.cos()).sum() if complex_ \
            else y.sin().sum()

    before = scan.launches
    loss().backward()
    assert scan.launches == before + 2
    grads = p.grad.clone(), x.grad.clone()
    p.grad = x.grad = None
    with pt.twins():
        loss().backward()
    torch.testing.assert_close(grads[0], p.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[1], x.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("complex_", [False, True])
def test_scan_kernel_is_deterministic(cuda, complex_):
    """Each tile composes every earlier tile's aggregate in a fixed tree,
    so two runs give y equal bit for bit."""
    p, x = _scan_case(cuda, (3, 150001), complex_, seed=6)
    y1 = scan.first_order_scan(p, x)
    y2 = scan.first_order_scan(p, x)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("complex_", [False, True])
def test_scan_kernel_in_a_cuda_graph(cuda, complex_):
    """A captured scan replays right on new inputs: its workspace slots are
    valid by an epoch kept on the device, not by a value from the host.
    The warm-up makes the capture stream's workspace, so the graph holds
    no zero-fill and every replay relies on the epoch.  After the first
    replay an eager scan on that stream grows its workspace, and freed
    memory of the old one's size is filled with ones: the graph keeps the
    workspace it captured."""
    p, x = _scan_case(cuda, (32, 19200), complex_, seed=7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan.first_order_scan(p, x)               # warm-up, as torch asks
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = scan.first_order_scan(p, x)
    captured = scan._workspaces[(p.device.index, side.cuda_stream)][0]
    for i, seed in enumerate((8, 9, 10)):
        p_new, x_new = _scan_case(cuda, (32, 19200), complex_, seed=seed)
        p.copy_(p_new)
        x.copy_(x_new)
        graph.replay()
        want = scan.first_order_scan(p_new, x_new)
        torch.cuda.synchronize()
        assert torch.equal(y, want)
        if i == 0:
            with torch.cuda.stream(side):
                scan.first_order_scan(*_scan_case(cuda, (4, 1100000), False))
                assert scan._workspaces[
                    (p.device.index, side.cuda_stream)][0] is not captured
                junk = [torch.ones(captured.numel(), dtype=torch.uint8,
                                   device=cuda) for _ in range(8)]
            side.synchronize()
            del junk


def test_scan_kernel_rejects(cuda):
    p, x = _scan_case(cuda, (2, 10), False)
    with pytest.raises(TypeError):
        scan.first_order_scan(p.double(), x.double())


def test_lpc_takes_the_solve_kernel(cuda):
    """2,048 frames of order 24 in float32 take the kernel; fewer frames
    and float64 take the plain paths."""
    x = torch.randn(8, 256, 400, **_f32(cuda, 3))
    lpc = pt.LPC(400, 24, device=cuda, dtype=torch.float32)
    before = solve.launches
    a = lpc(x)
    assert solve.launches == before + 1
    with pt.twins():
        want = lpc(x)
    assert float((a - want).abs().max()) < 1e-3 * float(want.abs().max())
    lpc(x[:, :100])
    lpc64 = pt.LPC(400, 24, device=cuda, dtype=torch.float64)
    a64 = lpc64(x.double())
    assert solve.launches == before + 1
    assert torch.isfinite(a64).all()


def test_first_order_poledf_takes_the_scan_kernel(cuda):
    kw = _f32(cuda, 4)
    x = torch.randn(4, 1600, **kw)
    a = torch.rand(4, 20, 2, **kw)
    a[..., 1] = 0.9 * (2 * a[..., 1] - 1)
    poledf = pt.AllPoleDigitalFilter(1, 80, device=cuda, dtype=torch.float32)
    before = scan.launches
    y = poledf(x, a)
    assert scan.launches == before + 1
    with pt.twins():
        want = poledf(x, a)
    torch.testing.assert_close(y, want, rtol=2e-5, atol=2e-5)
    poledf64 = pt.AllPoleDigitalFilter(1, 80, device=cuda,
                                       dtype=torch.float64)
    poledf64(x.double(), a.double())
    assert scan.launches == before + 1


@pytest.mark.parametrize("B,N,P,M,S", [(32, 240, 240, 199, 20),
                                       (32, 240, 80, 79, 20),
                                       (2, 13, 16, 39, 4),
                                       (3, 9, 18, 50, 3)])
def test_unchunked_cascade_kernel_matches_twin(cuda, B, N, P, M, S):
    """The B3 entry at both chip_smoke [K3] geometries, a padded half
    spectrum (nfft 128, K = 65) and P not a multiple of 4."""
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=5)
    nfft = (lane_aligned_nfft(2 * P + M + 1) if P >= 80
            else 1 << int(np.ceil(np.log2(2 * P + M + 1))))
    assert chunked_geometry(M, P, nfft) is None
    before = mlsa.launches_unchunked
    y = mlsa.cascade_unchunked_cuda(x.reshape(B, N, P), c, weights, a, P, 0,
                                    nfft)
    assert mlsa.launches_unchunked == before + S
    want = taylor_cascade_unchunked(x, c, weights, a, P, 0, nfft)
    _assert_cascade_close(y.reshape(B, N * P), want)


def test_unchunked_cascade_refuses_a_tile_too_large(cuda):
    """nfft 2,400 (K = 1,201), a geometry whose DFT-plan tile did not fit
    in a block: the direct FIR needs no transform, so the B3 entry runs it
    and matches the twin.  Only a geometry whose one-frame tile exceeds a
    block's shared memory is refused, with a clear error."""
    x, c, weights, a = _cascade_case(cuda, 2, 9, 240, 199, 3, seed=5)
    y = mlsa.cascade_unchunked_cuda(x.reshape(2, 9, 240), c, weights, a, 240,
                                    0, 2400)
    want = taylor_cascade_unchunked(x, c, weights, a, 240, 0, 2400)
    _assert_cascade_close(y.reshape(2, 9 * 240), want)
    x, c, weights, a = _cascade_case(cuda, 1, 2, 240, 30000, 1, seed=5)
    with pytest.raises(ValueError, match="one frame"):
        mlsa.cascade_unchunked_cuda(x.reshape(1, 2, 240), c, weights, a, 240,
                                    0, 2 * 240 + 30001)


@pytest.mark.parametrize("B,N,P,M,S,advance", [(2, 17, 18, 50, 3, 0),
                                               (1, 7, 5, 3, 4, 1),
                                               (2, 33, 80, 20, 3, 0),
                                               (1, 21, 16, 239, 3, 4),
                                               (3, 19, 20, 7, 5, 2),
                                               (2, 9, 240, 199, 4, 9),
                                               (1, 3, 2400, 199, 2, 0),
                                               (2, 11, 84, 130, 3, 3)])
def test_cascade_kernel_matches_direct(cuda, B, N, P, M, S, advance):
    """Both entries against taylor_cascade_direct at awkward geometries:
    P not a multiple of 4 or of the 8-output thread item, M < P, M >> P,
    advance > 0, N not a multiple of the tile's frames, a frame wider than
    a block's threads (P = 2,400), and x at an offset that is not
    16-byte aligned."""
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=6)
    want = taylor_cascade_direct(x, c, weights, a, P, advance)
    xq = x.reshape(B, N, P)
    y = mlsa.cascade_unchunked_cuda(xq, c, weights, a, P, advance,
                                    2 * P + M + 1)
    _assert_cascade_close(y.reshape(B, N * P), want)
    y = mlsa.cascade_chunked_cuda(xq, c, weights, a, P, advance, 3 * P)
    _assert_cascade_close(y.reshape(B, N * P), want)
    shifted = torch.empty(B * N * P + 1, device=cuda)[1:]
    shifted.copy_(x.reshape(-1))
    y = mlsa.cascade_unchunked_cuda(shifted.view(B, N, P), c, weights, a, P,
                                    advance, 2 * P + M + 1)
    _assert_cascade_close(y.reshape(B, N * P), want)


def test_vocoder_48k_takes_the_unchunked_kernel(cuda):
    """MelCepstralVocoder(frame_period=240, cascade="fused") at 48 kHz:
    the Newton kernel and the unchunked cascade entry, no chunked one."""
    voc = pt.MelCepstralVocoder(frame_length=1200, frame_period=240,
                                fft_length=2048, cep_order=24, alpha=0.55,
                                cascade="fused", device=cuda,
                                dtype=torch.float32)
    x = torch.randn(2, 9600, **_f32(cuda, 7))
    newton.launches = mlsa.launches = mlsa.launches_unchunked = 0
    y = voc.analysis_synthesis(x)
    assert (newton.launches, mlsa.launches_unchunked, mlsa.launches) == (
        10, 40, 0)
    with pt.twins():
        want = voc.analysis_synthesis(x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float((y - want).abs().max()) <= 1e-2 * float(want.abs().max())


# The tensor-core cascade (csrc/mlsa_cascade_tc.cu) against its twin in
# the same arithmetic: HIGH within 2e-5 of max|y| (fp32 sums in another
# order move a value's lo half by a bf16 step: 0.6e-6 to 4.7e-6 on the
# card), DEFAULT within 3e-3 (one bf16 step of an activation: 3e-4 to
# 1.0e-3), the arm's own class.
TC_BARS = {"HIGH": 2e-5, "DEFAULT": 3e-3}
TC_COUNTERS = ("launches_high", "launches_default",
               "launches_high_unchunked", "launches_default_unchunked")


def _tc_counts():
    return {k: getattr(mlsa, k) for k in TC_COUNTERS + (
        "launches", "launches_unchunked")}


def _tc_delta(before):
    return {k: v - before[k] for k, v in _tc_counts().items() if
            v != before[k]}


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("B,N,P,M,S,advance", [(1, 5, 16, 39, 1, 0),
                                               (2, 40, 16, 39, 4, 0),
                                               (3, 61, 80, 199, 20, 0),
                                               (2, 30, 18, 50, 3, 2),
                                               (1, 12, 16, 239, 3, 0),
                                               (32, 240, 80, 199, 20, 0),
                                               (2, 20, 16, 495, 3, 0)])
def test_tc_cascade_chunked_matches_twin(cuda, precision, B, N, P, M, S,
                                         advance):
    """The chunked entry: one tile, ragged tiles, three batch rows at the
    flagship's P and M, P not a multiple of 8 with advance > 0, Q = 15,
    the flagship itself (7,808 padded frame rows, 62 forward row tiles)
    and Q = 31 (a forward tile yields 98 rows); S launches on the arm's
    counter and no other."""
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=11)
    nfft_c = lane_aligned_nfft(3 * P)
    before = _tc_counts()
    y = mlsa.cascade_chunked_tc_cuda(x.reshape(B, N, P), c, weights, a, P,
                                     advance, nfft_c, precision)
    key = "launches_high" if precision == "HIGH" else "launches_default"
    assert _tc_delta(before) == {key: S}
    want = taylor_cascade_chunked(x, c, weights, a, P, advance, nfft_c,
                                  precision)
    err = float((y.reshape(B, N * P) - want).abs().max())
    assert err <= TC_BARS[precision] * float(want.abs().max()), err


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("B,N,P,M,S,advance", [(4, 50, 240, 199, 20, 0),
                                               (2, 13, 16, 39, 4, 0),
                                               (3, 9, 18, 50, 3, 3),
                                               (2, 40, 80, 79, 5, 0),
                                               (1, 300, 240, 199, 4, 0),
                                               (3, 61, 80, 79, 3, 1),
                                               (2, 9, 16, 30, 3, 50)])
def test_tc_cascade_unchunked_matches_twin(cuda, precision, B, N, P, M, S,
                                           advance):
    """The unchunked entry at [chain48]'s P=240, a padded half spectrum
    (nfft 128, K = 65), P not a multiple of 8, one batch row whose 302
    padded frames are no multiple of the 128-row tile (nor of the inverse
    tiles' 127), row tiles that span two batch rows (64 padded frames a
    row at P = 80, advance 1: n_blk = 4), and r0 = 0 (advance 50 past
    P + M = 46: no zero frame before a batch row)."""
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=12)
    nfft = (lane_aligned_nfft(2 * P + M + 1) if P >= 80
            else 1 << int(np.ceil(np.log2(2 * P + M + 1))))
    assert chunked_geometry(M, P, nfft) is None
    before = _tc_counts()
    y = mlsa.cascade_unchunked_tc_cuda(x.reshape(B, N, P), c, weights, a, P,
                                       advance, nfft, precision)
    key = ("launches_high_unchunked" if precision == "HIGH"
           else "launches_default_unchunked")
    assert _tc_delta(before) == {key: S}
    want = taylor_cascade_unchunked(x, c, weights, a, P, advance, nfft,
                                    precision)
    err = float((y.reshape(B, N * P) - want).abs().max())
    assert err <= TC_BARS[precision] * float(want.abs().max()), err


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
def test_tc_cascade_chunked_is_deterministic(cuda, precision):
    """Two calls of the chunked entry at the flagship geometry on the
    same inputs are equal bit for bit (no atomics, no order that moves)."""
    B, N, P, M, S = 32, 240, 80, 199, 20
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=18)
    nfft_c = lane_aligned_nfft(3 * P)
    ys = [mlsa.cascade_chunked_tc_cuda(x.reshape(B, N, P), c, weights, a, P,
                                       0, nfft_c, precision)
          for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1])


def test_tc_cascade_entry_dispatch_and_no_fallback(cuda):
    """taylor_cascade picks the kernel by precision: HIGHEST the fp32
    FIR, HIGH / DEFAULT the tensor-core kernel; float64 on the card is
    refused at every precision, and a geometry with no tile raises
    rather than falling back."""
    B, N, P, M, S = 2, 50, 80, 199, 20
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=13)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    for precision, key in (("HIGHEST", "launches"),
                           ("HIGH", "launches_high"),
                           ("DEFAULT", "launches_default")):
        before = _tc_counts()
        y = mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft, precision)
        assert _tc_delta(before) == {key: S}
        with pt.twins():
            want = mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft,
                                       precision)
        bar = TC_BARS.get(precision, 1e-5)
        assert float((y - want).abs().max()) <= bar * float(
            want.abs().max())
        with pytest.raises(TypeError):
            mlsa.taylor_cascade(x.double(), c.double(), weights.double(),
                                a.double(), P, 0, nfft, precision)
    x, c, weights, a = _cascade_case(cuda, 1, 3, 1200, 199, 2, seed=13)
    for precision in ("HIGH", "DEFAULT"):
        with pytest.raises(ValueError, match="no tile"):
            mlsa.taylor_cascade(x, c, weights, a, 1200, 0,
                                lane_aligned_nfft(2 * 1200 + 200), precision)


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
def test_tc_cascade_makes_no_host_read(cuda, precision):
    """After a geometry's first call (which copies its plans to the card
    once), a call of either entry enqueues its work with no synchronising
    read."""
    cases = []
    for P, M in ((80, 199), (240, 199)):
        x, c, weights, a = _cascade_case(cuda, 2, 12, P, M, 20, seed=14)
        cases.append((x, c, weights, a, P, 0,
                      lane_aligned_nfft(2 * P + M + 1), precision))
    for args in cases:
        mlsa.taylor_cascade(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in cases:
            mlsa.taylor_cascade(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("P,M", [(80, 199), (240, 199)])
@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
def test_tc_cascade_in_a_cuda_graph(cuda, precision, P, M):
    """The programmatic-dependent launches of either entry (the chunked at
    P=80, the unchunked at P=240) capture into a CUDA graph, which replays
    the eager result bit for bit on new inputs."""
    B, N, S = 4, 40, 20
    x, c, weights, a = _cascade_case(cuda, B, N, P, M, S, seed=15)
    nfft = lane_aligned_nfft(2 * P + M + 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft, precision)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft, precision)
    for seed in (16, 17):
        x_new, c_new, _, _ = _cascade_case(cuda, B, N, P, M, S, seed=seed)
        x.copy_(x_new)
        c.copy_(c_new)
        graph.replay()
        want = mlsa.taylor_cascade(x_new, c_new, weights, a, P, 0, nfft,
                                   precision)
        torch.cuda.synchronize()
        assert torch.equal(y, want)


def test_vocoder_at_reduced_precision_takes_the_tc_kernel(cuda):
    """MelCepstralVocoder(cascade="fused"): at HIGH the round trip runs
    Newton 10 and the HIGH chunked entry 40, and nothing of the fp32
    kernel; synthesize at DEFAULT runs the DEFAULT entry 20; at 48 kHz
    (P=240, Taylor order 25) HIGH takes the unchunked entry 50."""
    x = torch.randn(2, 3200, **_f32(cuda, 0))
    voc = pt.MelCepstralVocoder(cascade="fused", cascade_precision="HIGH",
                                device=cuda, dtype=torch.float32)
    newton.launches = 0
    before = _tc_counts()
    y = voc.analysis_synthesis(x)
    assert newton.launches == 10 and _tc_delta(before) == {
        "launches_high": 40}
    with pt.twins():
        want = voc.analysis_synthesis(x)
    assert float((y - want).abs().max()) <= 1e-2 * float(want.abs().max())
    low = pt.MelCepstralVocoder(cascade="fused", cascade_precision="DEFAULT",
                                device=cuda, dtype=torch.float32)
    mc = voc.analyze(x)
    before = _tc_counts()
    e = low.synthesize(x, mc)
    assert _tc_delta(before) == {"launches_default": 20}
    assert torch.isfinite(e).all()
    voc48 = pt.MelCepstralVocoder(frame_length=1200, frame_period=240,
                                  fft_length=2048, cep_order=24, alpha=0.55,
                                  taylor_order=25, cascade="fused",
                                  cascade_precision="HIGH", device=cuda,
                                  dtype=torch.float32)
    before = _tc_counts()
    y48 = voc48.analysis_synthesis(torch.randn(2, 9600, **_f32(cuda, 7)))
    assert _tc_delta(before) == {"launches_high_unchunked": 50}
    assert torch.isfinite(y48).all()


@pytest.mark.parametrize("B,T,N,length,lo,hi", [
    (32, 30000, 241, 514, 0, 29486),
    (3, 500, 40, 64, -90, 480),
    (2, 50, 9, 200, -20, 60),
    (3, 500, 40, 1, -90, 480),
    (3, 500, 41, 3, -90, 480),
    (2, 3000, 33, 79, -100, 3100),
    (2, 800, 11, 1026, -300, 900),
    (64, 20000, 241, 1026, 0, 18974),
    (5, 700, 3, 37, 600, 760),
])
def test_gather_kernel_matches_twin(cuda, B, T, N, length, lo, hi):
    """Exact, with starts clamped at both edges, windows longer than the
    row, lengths that are not multiples of 4 and N L not a multiple of a
    warp's 256 values."""
    x = torch.randn(B, T, **_f32(cuda, 8))
    s = torch.randint(lo, hi, (B, N), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(9))
    before = gather.launches
    got = gather.gather_windows(x, s, length)
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_windows_plain(x, s, length))


def test_gather_kernel_backward(cuda):
    """The adjoint through the overlap-add kernel, clamped overhangs
    folded onto the edge samples; sums in another order than the twin's
    index_add, so within 1e-5."""
    x = torch.randn(4, 3000, **_f32(cuda, 10)).requires_grad_(True)
    s = torch.randint(-300, 3100, (4, 200), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(11))
    g = torch.randn(4, 200, 257, **_f32(cuda, 12))
    before = (gather.launches, ola.launches)
    gather.gather_windows(x, s, 257).backward(g)
    assert (gather.launches, ola.launches) == (before[0] + 1, before[1] + 1)
    got = x.grad.clone()
    x.grad = None
    with pt.twins():
        gather.gather_windows(x, s, 257).backward(g)
    torch.testing.assert_close(got, x.grad, rtol=1e-5, atol=1e-5)


def _slots(cuda, B, P, L, out_len, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    t = torch.randint(0, out_len - L + 1, (B, P), device=cuda, generator=gen)
    t = torch.sort(t, dim=-1).values
    if P > 6:
        t[:, -5:] = t[:, -6:-5]      # repeats, as WORLD's invalid slots
    return t


@pytest.mark.parametrize("B,P,L,out_len", [(32, 743, 1024, 20224),
                                           (3, 50, 100, 700),
                                           (1, 5, 33, 33)])
def test_ola_kernel_matches_twin(cuda, B, P, L, out_len):
    """Deterministic: two launches agree bit for bit; against the twin
    (index_add, in another order) within 1e-5."""
    t = _slots(cuda, B, P, L, out_len, 13)
    r = torch.randn(B, P, L, **_f32(cuda, 14))
    before = ola.launches
    got = ola.overlap_add(t, r, out_len)
    assert ola.launches == before + 1
    assert torch.equal(got, ola.overlap_add(t, r, out_len))
    torch.testing.assert_close(got, ola.overlap_add_plain(t, r, out_len),
                               rtol=1e-5, atol=1e-5)


def test_ola_kernel_backward_and_range_check(cuda):
    t = _slots(cuda, 2, 60, 128, 2000, 15)
    r = torch.randn(2, 60, 128, **_f32(cuda, 16)).requires_grad_(True)
    g = torch.randn(2, 2000, **_f32(cuda, 17))
    before = gather.launches
    ola.overlap_add(t, r, 2000).backward(g)
    assert gather.launches == before + 1
    assert torch.equal(r.grad, gather.gather_windows_plain(g, t, 128))
    with pytest.raises(ValueError, match="lie in"):
        ola.overlap_add(t + 2000, r, 2000)
    with pytest.raises(ValueError, match="nondecreasing"):
        ola.overlap_add(torch.flip(t, (-1,)), r, 2000)


def test_world_vocoder_takes_gather_and_ola(cuda):
    """WorldVocoder on the card in float32: the windowed gathers of
    CheapTrick (3) and D4C (8), one overlap-add; float64 takes the
    twins."""
    x = torch.as_tensor(synth_speech(2, 4000), device=cuda)
    voc = pt.WorldVocoder(ap_algorithm="d4c", device=cuda,
                          dtype=torch.float32)
    gather.launches = ola.launches = 0
    y = voc.analysis_synthesis(x)
    assert (gather.launches, ola.launches) == (11, 1)
    assert y.shape == x.shape and torch.isfinite(y).all()
    voc64 = pt.WorldVocoder(ap_algorithm="tandem", device=cuda,
                            dtype=torch.float64)
    y64 = voc64.analysis_synthesis(x.double())
    assert (gather.launches, ola.launches) == (11, 1)
    assert torch.isfinite(y64).all()


def _ola_case(cuda, t, L, out_len, seed):
    """Two launches equal, equal to overlap_add_grouped, and within 1e-5
    of max|y| of the twin (index_add, in another order: with hundreds of
    slots over one sample, the float32 partial sums reach tens of times
    an output's size, so the bar is [K7]'s, relative to max|y|)."""
    B, P = t.shape
    r = torch.randn(B, P, L, **_f32(cuda, seed))
    before = ola.launches
    got = ola.overlap_add(t, r, out_len)
    assert ola.launches == before + 1
    assert torch.equal(got, ola.overlap_add(t, r, out_len))
    assert torch.equal(got, ola.overlap_add_grouped(t, r, out_len))
    want = ola.overlap_add_plain(t, r, out_len)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("B,P,L,out_len,repeat", [
    (2, 600, 1024, 4321, 500),     # 500 slots at one start, as WORLD's tail
    (3, 1, 100, 700, 0),           # one slot
    (2, 1, 1024, 1024, 0),         # one slot filling the row
    (2, 300, 1023, 5000, 40),      # L not a multiple of 4
    (4, 130, 37, 999, 0),          # L < the tile, out_len not a multiple
    (1, 65, 256, 257, 0),          # two groups, the second of one slot
    (5, 743, 1024, 20320, 550),    # [world]'s table size
])
def test_ola_kernel_awkward_tables(cuda, B, P, L, out_len, repeat):
    t = _slots(cuda, B, P, L, out_len, 18)
    if repeat:
        t[:, -repeat:] = t[:, -repeat - 1:-repeat]
    _ola_case(cuda, t, L, out_len, 19)


def test_ola_kernel_all_slots_at_one_start(cuda):
    t = torch.full((2, 500), 7, device=cuda)
    _ola_case(cuda, t, 64, 100, 20)
    _ola_case(cuda, torch.zeros_like(t), 100, 100, 21)


def test_ola_kernel_permuted_rows(cuda):
    """The gather's backward: sorted starts, responses in another order."""
    t = _slots(cuda, 3, 200, 130, 3000, 22)
    r = torch.randn(3, 200, 130, **_f32(cuda, 23))
    perm = torch.argsort(torch.rand(3, 200, device=cuda), dim=-1)
    got = ola.overlap_add_cuda(t, r, 3000, perm=perm)
    assert torch.equal(got, ola.overlap_add_grouped(t, r, 3000, perm=perm))
    want = ola.overlap_add_plain(
        t, torch.gather(r, 1, perm[..., None].expand(-1, -1, 130)), 3000)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_world_synthesis_makes_no_host_read(cuda):
    """The synthesis, its slot noise and its overlap-add enqueue without a
    synchronising call (the overlap-add's range check is off there)."""
    x = torch.as_tensor(synth_speech(2, 4000), device=cuda)
    voc = pt.WorldVocoder(ap_algorithm="d4c", device=cuda,
                          dtype=torch.float32)
    with torch.no_grad():
        f0, ap, sp = voc.analyze(x)
        voc.synthesize(f0, ap, sp)          # first call: plans, libraries
        torch.cuda.synchronize()
        before = (ola.launches, threefry.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = voc.synthesize(f0, ap, sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert (ola.launches, threefry.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.isfinite(y).all()


def _keys():
    return [prng.PRNGKey(0), prng.fold_in(prng.PRNGKey(5), 77),
            prng.split(prng.PRNGKey(2 ** 40 + 1), 3)[1]]


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 5, 333),
                                   (32, 241, 1024)])
def test_threefry_flat_matches_twin(cuda, shape):
    for key in _keys():
        before = threefry.launches
        got_bits = threefry.normal_cuda(key, shape, cuda, bits=True)
        assert threefry.launches == before + 1
        assert torch.equal(got_bits.long() & prng.MASK,
                           prng.bits(key.to(cuda), shape))
        torch.testing.assert_close(
            threefry.normal_cuda(key, shape, cuda),
            prng.normal(key.to(cuda), shape, torch.float32), rtol=0,
            atol=0)


@pytest.mark.parametrize("B,P,length,span,offset", [
    (1, 1, 1, 10, 0), (2, 9, 130, 4000, 0), (3, 7, 257, 2 ** 30 + 3, 1),
    (32, 743, 384, 19280, 0)])
def test_threefry_slot_matches_twin(cuda, B, P, length, span, offset):
    ti = torch.sort(torch.randint(0, 4000, (B, P), device=cuda,
                                  generator=torch.Generator(
                                      cuda).manual_seed(24)), -1).values
    if P > 3:
        ti[:, -3:] = ti[:, -4:-3]
    got_bits = threefry.slot_normal_cuda(5, ti, span, offset, length,
                                         bits=True)
    keys = prng.fold_in(prng.PRNGKey(5, cuda),
                        prng.slot_counters(ti, span, offset))
    assert torch.equal(got_bits.long() & prng.MASK,
                       prng.bits(keys, (length,)))
    torch.testing.assert_close(
        threefry.slot_normal_cuda(5, ti, span, offset, length),
        prng.slot_normal(5, ti, span, offset, length, torch.float32),
        rtol=0, atol=0)


def test_threefry_dispatch(cuda):
    """float32 on the card launches the kernel; float64 and twins() take
    the twin."""
    key = prng.PRNGKey(3)
    before = threefry.launches
    threefry.normal(key, (4, 9), torch.float32, cuda)
    assert threefry.launches == before + 1
    y64 = threefry.normal(key, (4, 9), torch.float64, cuda)
    with pt.twins():
        y32 = threefry.normal(key, (4, 9), torch.float32, cuda)
    assert threefry.launches == before + 1
    assert y64.dtype == torch.float64 and y32.is_cuda
    torch.testing.assert_close(y64, prng.normal(key, (4, 9),
                                                torch.float64).to(cuda))


# The mcep residual kernel at the benchmark's shapes: (frame length,
# period, FFT length, alpha, sample rate, rows, samples a row).
RESIDUAL_SHAPES = {
    "mcep16k.resynth": (400, 80, 512, 0.42, 16000, 128, 48000),
    "mcep48k.resynth": (1200, 240, 2048, 0.55, 48000, 64, 144000),
    "mcep16k.extract": (400, 80, 512, 0.42, 16000, 256, 48000),
}
# Its error from float64, of max|rt|, at most: read 4.6e-7 to 7.1e-7 on an
# H100 at these shapes, the float32 twin's 2.7e-7 to 1.6e-6 (its own sums
# in cuBLAS's order, lucky or not at a given shape).
RESIDUAL_BAR = 1e-5


def _residual_case(cuda, shape, smcep=False):
    frame, period, nfft, alpha, sr, rows, T = RESIDUAL_SHAPES[shape]
    x = torch.as_tensor(synth_speech(rows, T, sr), device=cuda)
    kw = dict(fft_length=nfft, cep_order=24, alpha=alpha, n_iter=1,
              device=cuda, dtype=torch.float32)
    op = (pt.SecondOrderAllPassMelCepstralAnalysis(theta=0.1, **kw) if smcep
          else pt.MelCepstralAnalysis(**kw))
    sp = pt.STFT(frame, period, nfft, out_format="power", device=cuda,
                 dtype=torch.float32)(x)
    log_x = torch.log(sp).reshape(-1, nfft // 2 + 1)
    mc_t = torch.matmul(log_x, op.P0).T.contiguous()
    return mc_t, log_x, op.P1, op.P2, op.alpha_vector


def _residual_gap(got, args) -> float:
    """max|got - float64| over max|rt| of float64, rt and ra alike (ra
    cancels as the iteration converges, so its own maximum is no scale)."""
    want = mcep_residual.mcep_residual_plain(*(a.double() for a in args))
    scale = float(want[0].abs().max())
    return max(float((g.double() - w).abs().max()) / scale
               for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("shape,cut,smcep,steps", [
    ("mcep16k.resynth", None, False, 0), ("mcep48k.resynth", None, False, 0),
    ("mcep16k.extract", None, False, 0), ("mcep16k.resynth", 76763, False, 0),
    ("mcep48k.resynth", 1001, False, 0), ("mcep16k.resynth", None, True, 0),
    ("mcep48k.resynth", 38399, True, 0), ("mcep16k.resynth", None, False, 5),
    ("mcep48k.resynth", None, False, 5), ("mcep16k.extract", None, False, 5)])
def test_mcep_residual_kernel_matches_twin(cuda, shape, cut, smcep, steps):
    """One launch, finite, within RESIDUAL_BAR of float64.  ``cut``
    frames: not a multiple of the 64-frame tile.  ``steps`` plain Newton
    steps first: near convergence ra cancels, where the bar is of max|rt|
    still."""
    args = _residual_case(cuda, shape, smcep)
    if cut is not None:
        args = (args[0][:, :cut].contiguous(), args[1][:cut].contiguous(),
                *args[2:])
    mc_t = args[0]
    for _ in range(steps):
        mc_t = mc_t + newton.newton_solve_t(
            *mcep_residual.mcep_residual_plain(mc_t, *args[1:]))
    args = (mc_t.contiguous(), *args[1:])
    before = mcep_residual.launches
    got = mcep_residual.mcep_residual_lane_major(*args)
    assert mcep_residual.launches == before + 1
    assert all(bool(torch.isfinite(g).all()) for g in got)
    gap = _residual_gap(got, args)
    assert gap < RESIDUAL_BAR, gap


@pytest.mark.parametrize("cls", ["MelCepstralAnalysis",
                                 "SecondOrderAllPassMelCepstralAnalysis"])
def test_mcep_residual_runs_once_an_iteration(cuda, cls):
    op = getattr(pt, cls)(fft_length=512, cep_order=24, alpha=0.42,
                          n_iter=10, device=cuda, dtype=torch.float32)
    sp = pt.STFT(400, 80, 512, out_format="power", device=cuda,
                 dtype=torch.float32)(
        torch.as_tensor(synth_speech(4, 8000), device=cuda))
    before = mcep_residual.launches, newton.launches
    mc = op(sp)
    assert (mcep_residual.launches - before[0],
            newton.launches - before[1]) == (10, 10)
    assert bool(torch.isfinite(mc).all())


def test_mcep_residual_kernel_rejects(cuda):
    args = _residual_case(cuda, "mcep16k.resynth")
    args = (args[0][:, :300].contiguous(), args[1][:300].contiguous(),
            *args[2:])
    with pytest.raises(TypeError):
        mcep_residual.mcep_residual_lane_major(*(a.double() for a in args))
    with pytest.raises(ValueError):
        mcep_residual.mcep_residual_lane_major(
            args[0], args[1].T.contiguous().T, *args[2:])
    n = 34
    with pytest.raises(ValueError):
        mcep_residual.mcep_residual_lane_major(
            torch.zeros(n, 300, device=cuda), args[1],
            torch.zeros(n, 257, device=cuda),
            torch.zeros(257, 2 * n - 1, device=cuda),
            torch.zeros(n, device=cuda))


def test_mcep_residual_kernel_backward(cuda):
    """The Function's backward behind the kernel against autograd through
    the twin, every input learnable."""
    args = _residual_case(cuda, "mcep16k.resynth")
    leaves = [a[..., :2000].contiguous() if i == 0 else
              a[:2000].contiguous() if i == 1 else a.clone()
              for i, a in enumerate(args)]
    g = torch.Generator(cuda).manual_seed(3)
    w_rt = torch.randn(49, 2000, device=cuda, generator=g)
    w_ra = torch.randn(25, 2000, device=cuda, generator=g)

    def grads(f):
        xs = [a.detach().requires_grad_(True) for a in leaves]
        rt, ra = f(*xs)
        ((w_rt * rt).sum() + (w_ra * ra).sum()).backward()
        return [a.grad for a in xs]

    before = mcep_residual.launches
    got = grads(mcep_residual.mcep_residual)
    assert mcep_residual.launches == before + 1
    want = grads(mcep_residual.mcep_residual_plain)
    for a, b in zip(got, want, strict=True):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale


def test_vocoder_analysis_on_the_card_within_the_mc_gap(cuda):
    """The flagship's analysis, float32 on the card (the residual and
    Newton kernels), against float64: under the benchmark's mc_gap limit,
    3e-5 of max|mc| (PERF.md section 2)."""
    x = torch.as_tensor(synth_speech(8, 48000), device=cuda)
    voc = pt.MelCepstralVocoder(cascade="fused", device=cuda,
                                dtype=torch.float32)
    before = mcep_residual.launches
    mc = voc.analyze(x)
    assert mcep_residual.launches == before + 10
    ref = pt.MelCepstralVocoder(cascade="fused", device=cuda,
                                dtype=torch.float64).analyze(x.double())
    gap = float((mc.double() - ref).abs().max() / ref.abs().max())
    assert gap < 3e-5, gap


def test_mcep_below_the_jax_batch_gate_takes_the_kernel(cuda):
    """64 frames, far below the JAX package's gate of 2,048 systems: the
    Newton kernel runs each of the 10 steps, within 2e-4 of float64."""
    x = synth_speech(1, 64 * 400).astype(np.float64).reshape(64, 400)
    X = np.abs(np.fft.rfft(x * np.hanning(400), 512)) ** 2 + 1e-8
    kw = dict(fft_length=512, cep_order=24, alpha=0.42, n_iter=10)
    op = pt.MelCepstralAnalysis(**kw, device=cuda, dtype=torch.float32)
    before = newton.launches
    got = op(torch.as_tensor(X, dtype=torch.float32, device=cuda))
    assert newton.launches == before + 10
    want = pt.MelCepstralAnalysis(**kw, device="cpu", dtype=torch.float64)(
        torch.as_tensor(X))
    torch.testing.assert_close(got.double().cpu(), want, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("algo,kw", [("fcnf0", {}),
                                     ("crepe", dict(model="tiny"))])
def test_neural_pitch_on_the_card_matches_the_cpu(cuda, algo, kw):
    """Full fp32 on the card against the port on the CPU in float32:
    voicing equal, f0 within 1e-4 relative; where TF32 is the network's
    precision (FCNF0), its f0 is within chip_smoke.TF32_CENTS of full
    fp32, voicing equal on 99 % of frames."""
    from chip_smoke import TF32_CENTS, cents_diff
    from diffsptk_tpu_torch.core import full_precision
    from diffsptk_tpu_torch.ops import pitch_nn as nn_
    x = torch.as_tensor(synth_speech(3, 12800))
    make = lambda dev: pt.Pitch(  # noqa: E731
        80, 16000, algorithm=algo, out_format="f0", device=dev,
        dtype=torch.float32, **kw).extractor
    ext = make(cuda)
    xc = x.to(cuda)

    @full_precision
    def f0_at(precision):
        """The extractor's f0 with its network at ``precision``, as
        ``Pitch.forward`` runs it."""
        frames = ext.frames(xc)
        if algo == "fcnf0":
            out = nn_.fcnf0_forward(ext.params, frames.reshape(-1, 1024),
                                    precision=precision)
            return ext.decode(out.reshape(*frames.shape[:-1], -1)).cpu()
        out = nn_.crepe_forward(ext.params, frames.reshape(-1, 1024),
                                ext.model, precision=precision)
        return ext.decode(out.reshape(*frames.shape[:-1], -1), xc).cpu()

    with torch.no_grad():
        want = make("cpu").calc_pitch(x)
        full, tf32 = f0_at("full"), f0_at("tf32")
        main = full_precision(ext.calc_pitch)(xc).cpu()
    assert torch.equal(main, tf32 if ext.PRECISION == "tf32" else full)
    assert torch.equal(full > 0, want > 0)
    voiced = want > 0
    torch.testing.assert_close(full[voiced], want[voiced], rtol=1e-4,
                               atol=0)
    assert torch.isfinite(tf32).all()
    if ext.PRECISION != "tf32":
        return                                    # full fp32 by default
    assert float(((tf32 > 0) == (full > 0)).double().mean()) >= 0.99
    both = (tf32 > 0) & (full > 0)
    assert float(cents_diff(tf32, full)[both].abs().max()) <= TF32_CENTS


def test_neural_pitch_weights_stay_float32_on_the_card(cuda):
    op = pt.Pitch(80, 16000, algorithm="fcnf0", device=cuda,
                  dtype=torch.float64)
    ext = op.extractor
    assert all(w.dtype == torch.float32 and w.is_cuda
               for w in ext.params.values())
    assert ext.bin_mask.dtype == torch.float64


def test_excitation_noise_takes_the_threefry_kernel(cuda):
    """The Gaussian unvoiced region draws through the kernel (one launch);
    the output equals the twin path's within the draws' bar."""
    p = torch.full((4, 200), 100.0, device=cuda)
    p[:, 50:120] = 0
    op = pt.ExcitationGeneration(80, device=cuda, dtype=torch.float32)
    before = threefry.launches
    e = op(p)
    assert threefry.launches == before + 1
    with pt.twins():
        e_p = op(p)
    assert threefry.launches == before + 1
    torch.testing.assert_close(e, e_p, rtol=1e-6, atol=0)
    assert float(e[:, 60 * 80:110 * 80].std()) > 0.5


def test_world_fcnf0_makes_no_host_read(cuda):
    """WorldVocoder with FCNF0: the pitch stage (the network and its
    decode) and the synthesis enqueue without a synchronising call."""
    x = torch.as_tensor(synth_speech(2, 4000), device=cuda)
    voc = pt.WorldVocoder(pitch_algorithm="fcnf0", ap_algorithm="d4c",
                          device=cuda, dtype=torch.float32)
    with torch.no_grad():
        f0, ap, sp = voc.analyze(x)
        voc.synthesize(f0, ap, sp)          # first call: plans, libraries
        torch.cuda.synchronize()
        before = (ola.launches, threefry.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            f0_again = voc.pitch(x)
            y = voc.synthesize(f0, ap, sp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert (ola.launches, threefry.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.equal(f0_again, f0) and torch.isfinite(y).all()


def test_crepe_viterbi_makes_no_host_read(cuda):
    op = pt.Pitch(80, 16000, algorithm="crepe", model="tiny",
                  out_format="f0", device=cuda, dtype=torch.float32)
    x = torch.as_tensor(synth_speech(2, 4000), device=cuda)
    with torch.no_grad():
        want = op(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = op(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


def _rel(got, want):
    got = got.detach().cpu().to(want.dtype)
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name,args,bar", [
    ("CQT", (64, 16000), 1e-3), ("MDCT", (256,), 1e-4),
    ("MDST", (64, "kbd"), 1e-4), ("PQMF", (4, 47), 1e-4),
    ("FractionalOctaveBandAnalysis", (16000,), 1e-4)])
def test_filterbanks_on_the_card_match_the_cpu(cuda, name, args, bar):
    """Each analysis and its inverse, float32 on the card against the
    port's float64 on the CPU, within ``bar`` of max|.|."""
    x = torch.as_tensor(synth_speech(3, 9600))
    kw = dict(n_bin=24) if name == "CQT" else {}
    fwd = getattr(pt, name)(*args, **kw, device=cuda, dtype=torch.float32)
    fwd64 = getattr(pt, name)(*args, **kw, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        c, c64 = fwd(x.to(cuda)), fwd64(x.double())
        assert c.device.type == cuda.type and _rel(c, c64) <= bar
        if name == "FractionalOctaveBandAnalysis":
            return
        inv_name = "I" + name
        inv = getattr(pt, inv_name)(*args, **kw, device=cuda,
                                    dtype=torch.float32)
        inv64 = getattr(pt, inv_name)(*args, **kw, device="cpu",
                                      dtype=torch.float64)
        if name == "PQMF":
            y, y64 = inv(c), inv64(c64)
        else:
            y, y64 = inv(c, out_length=9600), inv64(c64, out_length=9600)
        assert _rel(y, y64) <= bar


def test_spectral_conversions_on_the_card_match_the_cpu(cuda):
    mc = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4, 30, 25)) * 0.2)
    for op, kw in ((pt.MelCepstrumToMLSADigitalFilterCoefficients,
                    dict(cep_order=24, alpha=0.42)),
                   (pt.MLSADigitalFilterCoefficientsToMelCepstrum,
                    dict(cep_order=24, alpha=0.42)),
                   (pt.MelGeneralizedCepstrumToSpectrum,
                    dict(cep_order=24, fft_length=512, alpha=0.42,
                         out_format="complex")),
                   (pt.HilbertTransform, dict(fft_length=25))):
        got = op(**kw, device=cuda, dtype=torch.float32)(mc.float().to(cuda))
        want = op(**kw, device="cpu", dtype=torch.float64)(mc)
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mode,kw", [
    ("multi-stage", dict(cascade="stages")), ("single-stage", {}),
    ("freq-domain", {}), ("pade-approx", {})])
def test_vocoder_modes_on_the_card_match_the_cpu(cuda, mode, kw):
    """MelCepstralVocoder(mode=...) float32 on the card against float64 on
    the CPU, within the flagship's 1e-2 of max|y|; Newton runs 10 times,
    the scan kernel 10 times in Pade mode (five first-order sections in
    each of IMLSA and MLSA, complex64) and never otherwise."""
    x = torch.as_tensor(synth_speech(2, 3200))
    voc = pt.MelCepstralVocoder(mode=mode, **kw, device=cuda,
                                dtype=torch.float32)
    voc64 = pt.MelCepstralVocoder(mode=mode, **kw, device="cpu",
                                  dtype=torch.float64)
    dtypes = []
    orig = scan.first_order_scan

    def spy(p, xs):
        dtypes.append(xs.dtype)
        return orig(p, xs)

    scan.first_order_scan = spy
    try:
        newton.launches = scan.launches = 0
        with torch.no_grad():
            y = voc.analysis_synthesis(x.to(cuda))
        torch.cuda.synchronize()
    finally:
        scan.first_order_scan = orig
    pade = mode == "pade-approx"
    assert newton.launches == 10
    assert scan.launches == (10 if pade else 0)
    assert dtypes == ([torch.complex64] * 10 if pade else [])
    with torch.no_grad():
        assert _rel(y, voc64.analysis_synthesis(x.double())) <= 1e-2


def test_zerodf_fft_path_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 1600)))
    b = torch.as_tensor(rng.standard_normal((4, 20, 200)) * 0.1)
    f = pt.AllZeroDigitalFilter(199, 80, zeroth_index=10, device=cuda,
                                dtype=torch.float32)
    f64 = pt.AllZeroDigitalFilter(199, 80, zeroth_index=10, device="cpu",
                                  dtype=torch.float64)
    got = f(x.float().to(cuda), b.float().to(cuda))
    assert _rel(got, f64(x, b)) <= 1e-5


def test_plp24_takes_the_solve_kernel_once(cuda):
    """PLP at order 24 over 9 x 240 frames (above the kernel's gate of
    2,048) launches the SPD solve kernel once, twice with its backward,
    and agrees with float64 on the CPU."""
    sp = power_spectrum(torch, torch.as_tensor(synth_speech(9, 19200),
                                               device=cuda))
    op, op64 = (feature_ops(torch, dev, dt)["plp24"] for dev, dt in (
        (cuda, torch.float32), ("cpu", torch.float64)))
    solve.launches = 0
    with torch.no_grad():
        y = op(sp)
    torch.cuda.synchronize()
    assert solve.launches == 1
    assert _rel(y, op64(sp.double().cpu())) <= FEATURE_BARS["plp24"]
    spg = sp.clone().requires_grad_(True)
    solve.launches = 0
    op(spg).sum().backward()
    torch.cuda.synchronize()
    assert solve.launches == 2 and torch.isfinite(spg.grad).all()


@pytest.mark.parametrize("name", ["mfcc", "plp"])
def test_features_on_the_card_match_the_cpu(cuda, name):
    sp = power_spectrum(torch, torch.as_tensor(synth_speech(2, 19200),
                                               device=cuda))
    op, op64 = (feature_ops(torch, dev, dt)[name] for dev, dt in (
        (cuda, torch.float32), ("cpu", torch.float64)))
    with torch.no_grad():
        assert _rel(op(sp), op64(sp.double().cpu())) <= FEATURE_BARS[name]


def test_gammatone_takes_the_complex_scan_four_times(cuda):
    x = torch.as_tensor(synth_speech(2, 19200))
    kw = dict(device=cuda, dtype=torch.float32)
    ana = pt.GammatoneFilterBankAnalysis(16000, **kw)
    syn = pt.GammatoneFilterBankSynthesis(16000, **kw)
    dtypes = []
    orig = scan.first_order_scan

    def spy(p, xs):
        dtypes.append(xs.dtype)
        return orig(p, xs)

    scan.first_order_scan = spy
    try:
        scan.launches = 0
        with torch.no_grad():
            sub = ana(x.to(cuda))
        torch.cuda.synchronize()
    finally:
        scan.first_order_scan = orig
    assert scan.launches == 4 and dtypes == [torch.complex64] * 4
    ana64 = pt.GammatoneFilterBankAnalysis(16000, device="cpu",
                                           dtype=torch.float64)
    syn64 = pt.GammatoneFilterBankSynthesis(16000, device="cpu",
                                            dtype=torch.float64)
    sub64 = ana64(x.double())
    with torch.no_grad():
        assert _rel(sub, sub64) <= GAMMATONE_BARS["analysis"]
        assert _rel(syn(sub), syn64(sub64)) <= GAMMATONE_BARS["synthesis"]


def test_eig_roots_on_the_card_equal_the_cpu(cuda):
    """The eig roots of a CUDA batch come back on the card, equal to the
    CPU's: both are the same host computation."""
    a = torch.as_tensor(np.random.default_rng(8).standard_normal((64, 25)),
                        dtype=torch.float32)
    op = pt.PolynomialToRoots(24, method="eig", device=cuda,
                              dtype=torch.float32)
    got = op(a.to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.complex64
    want = pt.PolynomialToRoots(24, method="eig", device="cpu",
                                dtype=torch.float32)(a)
    assert torch.equal(got.cpu(), want)


@pytest.fixture(scope="module")
def ops_rest_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = torch.as_tensor(synth_speech(2, 19200), device="cuda")
    with torch.no_grad():
        sp = power_spectrum(torch, xs)
        feats = feature_ops(torch, "cuda", torch.float32)
        mfcc, plp24 = feats["mfcc"](sp), feats["plp24"](sp)
        ops = ops_rest_ops(torch, "cuda", torch.float32, sp.shape[-2])
        inputs = ops_rest_inputs(torch, ops, xs, sp, mfcc, plp24)
    return ops, inputs, sp.shape[-2]


@pytest.mark.parametrize("name", sorted(OPS_REST_BARS))
def test_ops_rest_on_the_card_match_the_cpu(ops_rest_case, name):
    """Each small signal op float32 on the card against float64 on the
    CPU, row 0, with no host read."""
    ops, inputs, frames = ops_rest_case
    op64 = ops_rest_ops(torch, "cpu", torch.float64, frames)[name]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = ops[name](*inputs[name])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = op64(*(a.double().cpu() for a in row0(name, inputs[name])))
    got = got if name == "dtw" else got[:1]
    assert _rel(got, want) <= OPS_REST_BARS[name]


def test_dtw_path_is_the_stated_host_step(ops_rest_case):
    ops, inputs, frames = ops_rest_case
    assert OPS_REST_HOST_STEPS == ("dtw-path",)
    path = ops["dtw-path"](*inputs["dtw-path"])
    assert path.device.type == "cuda"
    assert path[0].tolist() == [0, 0]
    assert path[-1].tolist() == [frames - 1, frames - 1]


@pytest.mark.parametrize("name", sorted(MISC_BARS))
def test_misc_on_the_card_match_the_cpu(cuda, name):
    """Each misc op float32 on the card, with no host read, against float64
    on the CPU on row 0 (32 x 4,800 samples: 60 frames a row)."""
    xs = torch.as_tensor(synth_speech(4, 4800), device=cuda)
    f0a, f0b = (torch.as_tensor(f, device=cuda) for f in f0_tracks(4, 60))
    with torch.no_grad():
        inputs = misc_inputs(torch, xs, f0a, f0b)[name]
        op = misc_ops(torch, "cuda", torch.float32)[name]
        op(*inputs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = op(*(None if a is None else a[:1] for a in inputs))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = misc_ops(torch, "cpu", torch.float64)[name](
            *misc_inputs(torch, xs[:1].double().cpu(), f0a[:1].double().cpu(),
                         f0b[:1].double().cpu())[name])
    assert _rel(got, want) <= MISC_BARS[name]


def test_lbg_two_runs_on_the_card_are_equal(cuda):
    """The same codebook-size trajectory, indices and codebook twice."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(np.concatenate([
        rng.standard_normal((4096, 25)) * 0.3 + rng.standard_normal(25),
        rng.standard_normal((4096, 25))]).astype(np.float32), device=cuda)
    runs = []
    for _ in range(2):
        sizes = []
        cb, idx, dist = pt.LBG(24, 64, n_iter=10, batch_size=2048,
                               min_data_per_cluster=8, device=cuda)(
            x, return_indices=True,
            callback=lambda codebook_size, **kw: sizes.append(
                codebook_size))
        runs.append((sizes, idx, cb))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])


def test_functional_takes_the_kernels(cuda):
    """mcep and smcep take the Newton kernel 10 times a call, PLP-24,
    levdur and LPC at order 24 over 7,680 frames the SPD solve kernel
    once, as their classes do, and give their classes' values."""
    xs = torch.as_tensor(synth_speech(32, 19200), device=cuda)
    mods = {"newton": newton, "solve": solve}
    with torch.no_grad():
        for name, fn, args, kw, kernel, expected in functional_kernel_rows(
                torch, xs):
            mods[kernel].launches = 0
            y = fn(*args, **kw)
            torch.cuda.synchronize()
            assert mods[kernel].launches == expected, name
            assert y.device.type == "cuda" and bool(torch.isfinite(y).all())
            mods[kernel].launches = 0
            want = class_path(torch, fn, args, kw)
            assert mods[kernel].launches == expected, name
            assert rel_to_max(torch, y, want) <= 1e-6, name


def test_median_filter_beyond_quantile_limit(cuda):
    """4 x 2^20 frames of 5 features, windows of 4: 84 million window
    elements, more than torch.quantile's 2^24.  The card's result equals
    the CPU's run a batch row at a time, and a slice equals
    torch.nanquantile's."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 1 << 20, 5)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.1] = 0.0
    x = torch.as_tensor(x)
    kw = dict(magic_number=0.0, dtype=torch.float32)
    with torch.no_grad():
        card = pt.MedianFilter(4, device=cuda, **kw)(x.to(cuda)).cpu()
        op = pt.MedianFilter(4, device="cpu", **kw)
        chunked = torch.cat([op(x[i:i + 1]) for i in range(4)])
    assert torch.equal(card, chunked)
    plain = pt.MedianFilter(4, device="cpu", dtype=torch.float32)
    y = x[:1, :4096]
    windows = torch.nn.functional.pad(y, (0, 0, 2, 1), value=float("nan")
                                      ).unfold(1, 4, 1)
    torch.testing.assert_close(plain(y), torch.nanquantile(windows, 0.5,
                                                           dim=-1))


def test_roots_to_polynomial_and_griffin_make_no_host_read(cuda):
    """ROADMAP C.15: writing the scalar 1 into a complex CUDA tensor, and a
    key built from a host list, each copied from the host and waited for
    the card; both are now made on the card."""
    roots = torch.polar(torch.rand(8, 6, device=cuda) * 0.9,
                        torch.rand(8, 6, device=cuda) * 3.0)
    mag = torch.rand(2, 11, 33, device=cuda) + 0.1
    op = pt.RootsToPolynomial(6, device=cuda)
    gl = pt.GriffinLim(32, 16, 64, n_iter=2, device=cuda)
    with torch.no_grad():
        op(roots)
        gl(mag)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = op(roots)
            y = gl(mag)
            key = prng.PRNGKey(7, device=cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert a.shape == (8, 7) and y.shape[0] == 2
    assert key.tolist() == prng.PRNGKey(7).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_random_draws_on_the_card(cuda, dtype):
    """nrand, rand, the initial codebook and NMF's two factors draw on the
    card with no host read.  A float32 draw launches the threefry kernel:
    its uniform values and normals equal the host's bit for bit, as [K8]
    holds them (ROADMAP C.13).  A float64 draw takes the twin there:
    uniform values bit for bit, normals within rtol 1e-12 (the card's
    float64 erfinv need not round as the host's)."""
    key = prng.PRNGKey(11)
    launch = int(dtype == torch.float32)
    torch.cuda.synchronize()
    threefry.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        draws = (pt.nrand(6, 99, key=key, dtype=dtype, device=cuda),
                 pt.rand(6, 99, key=key, a=-1, b=2, dtype=dtype, device=cuda),
                 pt.VectorQuantization(9, 16, seed=3, dtype=dtype,
                                       device=cuda).codebook.detach(),
                 pt.NMF(30, 9, 4, dtype=dtype, device=cuda).H)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert threefry.launches == 5 * launch
    host = (pt.nrand(6, 99, key=key, dtype=dtype, device="cpu"),
            pt.rand(6, 99, key=key, a=-1, b=2, dtype=dtype, device="cpu"),
            pt.VectorQuantization(9, 16, seed=3, dtype=dtype,
                                  device="cpu").codebook.detach(),
            pt.NMF(30, 9, 4, dtype=dtype, device="cpu").H)
    for got, want, normal in zip(draws, host, (True, False, True, False)):
        assert got.is_cuda and got.dtype == dtype
        if normal:
            torch.testing.assert_close(got.cpu(), want, atol=0,
                                       rtol=0 if launch else 1e-12)
        else:
            assert torch.equal(got.cpu(), want)


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) CUDA mesh over an NCCL process group of world size 1 (an
    in-process store), destroyed after the test."""
    import datetime

    import torch.distributed as dist

    from diffsptk_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield make_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def _no_read_launches(fn):
    """``fn()``'s result and each kernel's launches in it, called once
    to warm (plans and caches) and once under the sync debug mode "error"
    (a host read raises)."""
    fn()
    torch.cuda.synchronize()
    mods = {"newton": newton, "mcep_residual": mcep_residual,
            "gather": gather, "ola": ola, "threefry": threefry}
    for m in mods.values():
        m.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, {k: m.launches for k, m in mods.items() if m.launches}


def test_sharded_vocoder_on_one_nccl_rank(nccl_mesh):
    """ShardedMelCepstralVocoder through NCCL at world size 1 equals the
    one-rank MelCepstralVocoder (its folded cascade, the sharded one's
    form) within [sharded]'s bar, launches the Newton kernel (B1) and the
    mcep residual kernel ten times an analysis each and reads nothing back
    to the host."""
    from diffsptk_tpu_torch.parallel import ShardedMelCepstralVocoder
    x = torch.as_tensor(synth_speech(4, 19200), device="cuda")
    kw = dict(device="cuda", dtype=torch.float32)
    voc = ShardedMelCepstralVocoder(nccl_mesh, **kw)
    with torch.no_grad():
        y, launches = _no_read_launches(lambda: voc.analysis_synthesis(x))
        want = pt.MelCepstralVocoder(cascade="folded",
                                     **kw).analysis_synthesis(x)
    assert launches == SHARDED_LAUNCHES["vocoder"] == {
        "newton": 10, "mcep_residual": 10}
    assert rel_to_max(torch, y, want) <= SHARDED_BARS["vocoder"]


def test_sharded_world_on_one_nccl_rank(nccl_mesh):
    """ShardedWorldVocoder (TANDEM) through NCCL at world size 1 equals the
    one-rank WorldVocoder's synthesis of its even frames within
    [sharded]'s bar, launches the overlap-add kernel (B7) once, the gather
    kernel (B6) and the threefry kernel as SHARDED_LAUNCHES states, and
    reads nothing back to the host."""
    from diffsptk_tpu_torch.parallel import ShardedWorldVocoder
    x = torch.as_tensor(synth_speech(4, 19200), device="cuda")
    kw = dict(device="cuda", dtype=torch.float32)
    wv = ShardedWorldVocoder(nccl_mesh, 80, 16000, 1024, **kw)
    one = pt.WorldVocoder(80, 16000, 1024, ap_algorithm="tandem", **kw)
    with torch.no_grad():
        y, launches = _no_read_launches(lambda: wv.analysis_synthesis(x))
        want = one.synthesize(*one.analyze(x, even_frames=True))
    assert launches == SHARDED_LAUNCHES["world"]
    assert launches["ola"] == 1
    assert rel_to_max(torch, y, want) <= SHARDED_BARS["world"]


def test_sharded_train_step_on_one_nccl_rank(nccl_mesh):
    """The JAX package's multi-chip training step (parallel/train.py,
    ``DryrunStep``) through NCCL at world size 1 on rows 0-1 of
    [sharded-train]'s input (2 x 19,200) from stable_lpc's coefficients:
    a step launches the overlap-add kernel (B7) once, the gather (B6) and
    the threefry kernel as SHARDED_TRAIN_LAUNCHES states and reads nothing
    back to the host, and its loss, its WORLD term and the gradients of
    window, mc and lpc lie within SHARDED_TRAIN_BARS of the same step on
    the CPU in float64 (the plain twins), whose WORLD draws the card's
    noise (``NoiseTape``)."""
    from chip_smoke import (
        SHARDED_TRAIN_B,
        SHARDED_TRAIN_BARS,
        SHARDED_TRAIN_LAUNCHES,
        SHARDED_TRAIN_T,
        NoiseTape,
        train_errs,
        train_grads,
        train_pytree,
    )
    from diffsptk_tpu_torch.ops import world_common as wc
    from diffsptk_tpu_torch.parallel.train import DryrunStep, dryrun_inputs
    inputs = {k: v[:2] for k, v in dryrun_inputs(
        SHARDED_TRAIN_B, SHARDED_TRAIN_T, np.float32).items()}
    card = DryrunStep(nccl_mesh, device="cuda", dtype=torch.float32)
    params = train_pytree(card, inputs, True)
    x, target = card.blocks(inputs)
    p = card.params_from_jax(params)
    (loss, _), launches = _no_read_launches(
        lambda: card.train_step(p, x, target))
    assert launches == SHARDED_TRAIN_LAUNCHES
    assert torch.isfinite(loss)
    tape = NoiseTape(torch, wc, card.world.synth)
    undo = tape.record()
    try:
        got = train_grads(card, params, x, target)
    finally:
        undo()
    # the CPU step on the same values and the card's WORLD noise: the
    # size-1 mesh sends nothing
    cpu = DryrunStep(nccl_mesh, device="cpu", dtype=torch.float64)
    rows = {k: v.astype(np.float64) for k, v in inputs.items()}
    params64 = {"window": {k: v.astype(np.float64)
                           for k, v in params["window"].items()},
                "mc": rows["mc"], "lpc": params["lpc"].astype(np.float64)}
    undo = tape.replay(cpu.world.synth, rows=2)
    try:
        want = train_grads(cpu, params64, *cpu.blocks(rows))
    finally:
        undo()
    errs = train_errs(torch, got, want)
    assert all(errs[k] <= SHARDED_TRAIN_BARS[k] for k in errs), errs


def _train_tool(name: str):
    """A trainer of ``tools/`` (``tools/<name>.py``), loaded by path."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fcnf0_train_step_makes_no_host_read(cuda):
    """One FCNF0 step on the card (the device corpus through the threefry
    kernel, the network in TF32 forward and backward, Adam) under the sync
    debug mode "error": no host read, ``CORPUS_LAUNCHES`` launches, a
    finite loss, parameters moved."""
    from diffsptk_tpu_torch.ops.pitch_nn import init_fcnf0_params

    TF = _train_tool("torch_train_fcnf0")
    trainer = TF.Trainer(init_fcnf0_params(0), cuda)
    before = trainer.params["head.bias"].detach().clone()
    keys = prng.split(prng.PRNGKey(99), 2)

    def step(key):
        return trainer.step(*TF.synth_batch_device(key, 8, cuda))

    step(keys[0])                          # builds and plans
    torch.cuda.synchronize()
    threefry.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step(keys[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert threefry.launches == TF.CORPUS_LAUNCHES
    assert bool(torch.isfinite(loss))
    assert not torch.equal(trainer.params["head.bias"].detach(), before)


def test_crepe_train_step_makes_no_host_read(cuda):
    """One CREPE-tiny step on the card on a batch already there: no host
    read, a finite loss, the running statistics moved and finite."""
    from diffsptk_tpu_torch.ops.pitch_nn import init_crepe_params

    TC = _train_tool("torch_train_crepe_tiny")
    trainer = TC.Trainer(init_crepe_params("tiny", seed=0), cuda, steps=10)
    x, y = (torch.as_tensor(a, device=cuda)
            for a in TC.synth_batch(np.random.default_rng(0), 8))
    trainer.step(x, y)
    mean = trainer.params["conv2_BN.running_mean"].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.step(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(loss))
    assert not torch.equal(trainer.params["conv2_BN.running_mean"], mean)
    assert all(bool(torch.isfinite(p).all())
               for p in trainer.params.values())


def test_device_corpus_draws_equal_the_twin(cuda):
    """The device corpus's draws from the threefry kernel equal the twin's
    on the card and on the host bit for bit, the integers too."""
    TF = _train_tool("torch_train_fcnf0")
    key = prng.PRNGKey(5)
    threefry.launches = 0
    got = TF.corpus_draws(key, 64, cuda)
    assert threefry.launches == TF.CORPUS_LAUNCHES
    with pt.twins():
        twin = TF.corpus_draws(key, 64, cuda)
    host = TF.corpus_draws(key, 64, "cpu")
    for name, value in got.items():
        assert value.is_cuda and value.dtype == host[name].dtype, name
        assert torch.equal(value, twin[name]), name
        assert torch.equal(value.cpu(), host[name]), name


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.02, 0.02), (60.0, 500.0),
                                    (3.713572066704308, 7.170119543449628),
                                    (-1.0, 2.0)])
def test_threefry_uniform_entry_matches_twin(cuda, bounds):
    """A float32 uniform draw on [minval, maxval) is one launch of the
    kernel's uniform entry, equal to the twin's on the host bit for bit
    (the scale and shift one fused multiply-add on both)."""
    key = prng.PRNGKey(21)
    threefry.launches = 0
    got = threefry.uniform(key, (3, 50001), torch.float32, cuda, *bounds)
    assert threefry.launches == 1
    want = prng.uniform(key, (3, 50001), torch.float32, *bounds)
    assert torch.equal(got.cpu(), want)
