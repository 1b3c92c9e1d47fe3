"""The port's CUDA kernels against their plain twins on the card.

Marked ``gpu``; without a card every test skips (decided in the
``cuda`` fixture).  Runs on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest imports JAX, which the
port's machine need not have).  This file imports no JAX.

Tolerances: the Newton kernel within 2e-4 (rtol and atol) of its twin,
the cascade kernel (both entries) within 1e-5 of max|y| of the folded
twin and of the direct plain version (fp32 arithmetic in another order
than the twin's matmuls and the direct version's sums); the windowed
gather equal to
its twin (a copy); the overlap-add and the gather's backward within 1e-5
of their twins (sums in another order than index_add's), and the
overlap-add equal to overlap_add_grouped (its own order, in torch); the
threefry kernel's bits equal to its twin's and its normals within rtol 1e-6
(fused multiply-adds in erfinv's polynomial); the SPD solve kernel within
1e-4 of max|x| of its twin, its backward rtol 1e-3 / atol 1e-4; the scan kernel
within 2e-5 (float32) and 1e-4 (complex64) of its twin, its backward
within 1e-4 (the tolerances of tests/test_pallas_scan.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from chip_smoke import synth_speech
from diffsptk_tpu_torch.kernels import (
    gather,
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
                                 (64, 2050)])
def test_spd_solve_kernel_matches_twin(cuda, n, B):
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
            prng.normal(key.to(cuda), shape, torch.float32), rtol=1e-6,
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
        rtol=1e-6, atol=0)


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
