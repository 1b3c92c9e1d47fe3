"""The MLSA cascade's reduced-precision arms on the CPU: the port's twins
at "HIGH" (bf16x3) and "DEFAULT" (one bf16 pass) against the JAX package.

The JAX package computes the HIGH arm on the CPU too (its bf16 casts are
explicit), so the HIGH twins are held to ``_chunked_kernel_b3`` and
``_cascade_kernel_b3`` in interpret mode within 1e-5 of max|y|: the two
sit 0.4e-6 to 2.1e-6 apart at these shapes, about the arm's own distance
from float64 (1.5e-6 to 3.4e-6), since an fp32 rounding of another order
moves a value's lo half by one bf16 step.  XLA's CPU backend ignores
DEFAULT, so that arm is held to float64 (within 3e-3 of max|y| at the
MGLSA filter's transform lengths; see
``test_default_twin_is_live_and_near_float64``) and shown not to be the
fp32 result.  The
modules at each precision against the JAX modules (full fp32 on the CPU
at every setting): HIGHEST and HIGH within 1e-4 of max|y| (the float32
rtol) and DEFAULT within 3e-3 for one MLSA pass; the vocoder at
``VOCODER_BARS``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import diffsptk_tpu_torch as pt
from diffsptk_tpu.kernels.mlsa_cascade import (
    lane_aligned_nfft as j_lane_aligned_nfft,
)
from diffsptk_tpu.kernels.pallas_mlsa import (
    _cascade_pallas,
    _cascade_pallas_chunked,
    _chunked_plan_b3,
    _fused_plan_b3,
    _pad128,
)
from diffsptk_tpu.ops.mglsadf import PseudoMGLSADigitalFilter as JMLSA
from diffsptk_tpu_torch.kernels import mlsa
from diffsptk_tpu_torch.kernels.mlsa_cascade import (
    bf16_round,
    cascade_plan,
    chunk_split,
    coef_spectrum,
    lane_aligned_nfft,
    split_plans,
    taylor_cascade_chunked,
    taylor_cascade_folded,
    taylor_cascade_unchunked,
)

RNG = np.random.default_rng(15)
F32 = dict(device="cpu", dtype=torch.float32)


def _case(B, N, P, M, S, dtype=np.float32, rng=RNG):
    x = rng.standard_normal((B, N * P)).astype(dtype)
    base = rng.standard_normal((B, 1, M + 1)) * (0.8 ** np.arange(M + 1))
    c = (base * (1 + 0.05 * rng.standard_normal((B, N, M + 1)))
         * 0.3).astype(dtype)
    weights = (1.0 / np.cumprod([1.0] + list(range(1, S + 1)))).astype(dtype)
    a = np.ones(S + 1, dtype)
    return x, c, weights, a


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _rel(got, want) -> float:
    got, want = (np.asarray(v.detach() if isinstance(v, torch.Tensor)
                            else v, np.float64) for v in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,N,P,M,S,advance", [(4, 6, 16, 39, 4, 0),
                                               (2, 5, 16, 30, 3, 5),
                                               (3, 4, 32, 95, 4, 0)])
def test_high_chunked_twin_matches_pallas_b3(B, N, P, M, S, advance):
    """The tap-chunked HIGH twin against _chunked_kernel_b3."""
    nfft_c = j_lane_aligned_nfft(3 * P)
    x, c, weights, a = _case(B, N, P, M, S)
    want = np.asarray(_cascade_pallas_chunked(
        jnp.asarray(x.reshape(B, N, P)), jnp.asarray(c), jnp.asarray(weights),
        jnp.asarray(a), P, advance, nfft_c, interpret=True,
        precision="HIGH")).reshape(B, N * P)
    got = taylor_cascade_chunked(*_t(x, c, weights, a), P, advance, nfft_c,
                                 "HIGH")
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("B,N,P,M,S,advance", [(2, 6, 16, 39, 4, 0),
                                               (1, 5, 16, 30, 3, 5),
                                               (3, 4, 32, 63, 6, 0)])
def test_high_unchunked_twin_matches_pallas_b3(B, N, P, M, S, advance):
    """The unchunked HIGH twin against _cascade_kernel_b3."""
    nfft = 1 << int(np.ceil(np.log2(2 * P + M + 1)))
    x, c, weights, a = _case(B, N, P, M, S)
    K = nfft // 2 + 1
    cspec = np.fft.rfft(c, n=nfft)
    pad = [(0, 0), (0, 0), (0, _pad128(K) - K)]
    cre = jnp.asarray(np.pad(cspec.real.astype(np.float32), pad))
    cim = jnp.asarray(np.pad(cspec.imag.astype(np.float32), pad))
    want = np.asarray(_cascade_pallas(
        jnp.asarray(x.reshape(B, N, P)), cre, cim, jnp.asarray(weights),
        jnp.asarray(a), P, M, advance, nfft, interpret=True,
        precision="HIGH")).reshape(B, N * P)
    got = taylor_cascade_unchunked(*_t(x, c, weights, a), P, advance, nfft,
                                   "HIGH")
    assert _rel(got, want) <= 1e-5


def _b3_halves(F_b3, G_b3, n_blk, Kp, lanes):
    """The hi / lo halves of the JAX package's bf16x3 plans, unpadded:
    forward blocks [F_hi; F_lo; F_hi] per r-block, inverse rows
    [Gre_hi; Gre_lo; Gre_hi; Gim_hi; Gim_lo; Gim_hi]."""
    F = np.asarray(F_b3, np.float32).reshape(n_blk, 3, 128, 2 * Kp)
    G = np.asarray(G_b3, np.float32).reshape(6, Kp, lanes)
    return F[:, 0], F[:, 1], G[0], G[1], G[3], G[4]


@pytest.mark.parametrize("chunked,nfft,m,p,advance", [
    (True, 254, 79, 80, 0), (True, 126, 15, 16, 5),
    (False, 510, 199, 80, 0), (False, 128, 30, 16, 5)])
def test_plan_splits_match_jax(chunked, nfft, m, p, advance):
    """split_plans' hi and lo halves are those of _chunked_plan_b3 and
    _fused_plan_b3 (padding aside), and reconstruct the same fp32 plans."""
    K = nfft // 2 + 1
    if chunked:
        F_b3, G_b3, r0, n_blk, Kp = _chunked_plan_b3(nfft, p, advance)
        lanes = 2 * 128
    else:
        F_b3, G_b3, r0, n_blk, Kp = _fused_plan_b3(nfft, m, p, advance)
        lanes = 3 * 128
    fh, fl, gre_h, gre_l, gim_h, gim_l = _b3_halves(F_b3, G_b3, n_blk, Kp,
                                                    lanes)
    fwd, (pre_h, pre_l), (pim_h, pim_l), r0_, n_blk_ = split_plans(
        nfft, m, p, advance, "cpu")
    assert (r0_, n_blk_) == (r0, n_blk)
    blocks = range(lanes // 128)
    for r, (h, lo) in enumerate(fwd):
        for got, want in ((h, fh[r]), (lo, fl[r])):
            got = got.numpy()
            np.testing.assert_array_equal(got[:, :K], want[:p, :K])
            np.testing.assert_array_equal(got[:, K:], want[:p, Kp:Kp + K])
        np.testing.assert_array_equal(
            (h + lo).numpy()[:, :K], fh[r][:p, :K] + fl[r][:p, :K])
    for got, want in ((pre_h, gre_h), (pre_l, gre_l), (pim_h, gim_h),
                      (pim_l, gim_l)):
        for j in blocks:
            np.testing.assert_array_equal(
                got.numpy()[:, j * p:(j + 1) * p],
                want[:K, j * 128:j * 128 + p])


def _tc_emulated(x, c, weights, a, P, advance, nfft, precision, chunked):
    """The tensor-core entries (csrc/mlsa_cascade_tc.cu, tc_fwd_kernel /
    tc_inv_kernel) in torch, from the plans as ``mlsa.tc_plans`` lays them
    out for them (unswizzled): the padded state (pre = Q - 1 + r0 zero
    frames before each batch row, ``after`` after it, frames P8 wide; Q = 1
    unchunked), its context rows (the view at row stride P8: row i of a
    batch row is frame i - (Q - 1)), the forward tiles of 128 rows stepping
    by 129 - Q from row 1 - Q (the first Q - 1 rows of a tile its halo)
    with the bins' re and im side by side (``mlsa.forward_bins``' order),
    the Q-term complex products of their epilogue on the tile's own rows
    (frame N on C[N-1]) and Y split, the inverse tiles of 127 frames and a
    halo row with the lo / hi column groups of 8, and the next state
    written split by the inverse epilogue."""
    B, T = x.shape
    N, M = c.shape[-2], c.shape[-1] - 1
    if chunked:
        taps, Q = chunk_split(c, P)                       # (B, N, Q, P)
        m = P - 1
    else:
        taps, Q, m = c[:, :, None], 1, M
    f_hi, f_lo, g_hi, g_lo, r0, n_blk, K, lay = mlsa.tc_plans(
        nfft, m, P, advance, precision, "cpu", Q, chunked)
    Fh, Fl = (mlsa.unswizzle128(t).float() for t in (f_hi, f_lo))
    Gh, Gl = (mlsa.unswizzle128(t).float() for t in (g_hi, g_lo))
    high = precision == "HIGH"
    rows = mlsa.TC_TILE_ROWS
    qh = Q - 1
    Np = lay.pre + N + lay.after
    Mr = B * Np
    frames = Mr + n_blk
    cre, cim = coef_spectrum(taps, nfft)                  # (B, N, Q, K)
    f32 = dict(dtype=torch.float32)   # whatever torch's default dtype

    def split(v):
        hi = bf16_round(v)
        return hi, (bf16_round(v - hi) if high else torch.zeros_like(v))

    def gemm(ah, al, bh, bl):
        out = ah @ bh.T
        return out + ah @ bl.T + al @ bh.T if high else out

    def tile(t, t0, n):
        """Rows t0 .. t0 + n of t, zero before 0 and past its end
        (cp.async's fill)."""
        idx = torch.arange(t0, t0 + n)
        ok = (idx >= 0) & (idx < t.shape[0])
        out = t.new_zeros(n, t.shape[1])
        out[ok] = t[idx[ok]]
        return out

    at = (torch.arange(B)[:, None] * Np + lay.pre
          + torch.arange(N)[None, :]).reshape(-1)        # frame f of row b
    st = torch.zeros(frames, lay.P8, **f32)
    st[at, :P] = x.reshape(B * N, P)
    sh, sl = split(st)
    row = torch.arange(Mr)
    b_of, m_of = row // Np, row % Np - qh
    nc = m_of.clamp(0, N - 1)
    live = ((m_of >= 0) & (m_of <= N))[:, None]
    kb, part = mlsa.forward_bins(lay)
    pl = torch.arange(lay.w)
    col = 16 * (pl // 8) + pl % 8                         # lo of p; hi +8
    y = a[0] * x.reshape(B, N, P)
    for s in range(1, a.shape[0]):
        ctx = [F.pad(t.reshape(-1).unfold(0, lay.kf, lay.P8)[:Mr],
                     (0, lay.Kf - lay.kf)) for t in (sh, sl)]
        Y = torch.zeros(Mr, 2 * lay.Kp, **f32)
        for t0 in range(-qh, Mr - qh, rows - qh):
            X = gemm(tile(ctx[0], t0, rows), tile(ctx[1], t0, rows), Fh, Fl)
            xr = torch.zeros(rows, K, **f32)
            xi = torch.zeros(rows, K, **f32)
            for e, part_x in ((0, xr), (1, xi)):
                sel = (part == e) & (kb < K)
                part_x[:, kb[sel]] = X[:, sel]
            r = torch.arange(qh, rows)
            r = r[t0 + r < Mr]
            ri = t0 + r
            yre = torch.zeros(len(r), K, **f32)
            yim = torch.zeros(len(r), K, **f32)
            for j in range(Q):
                cr, ci = cre[b_of[ri], nc[ri], j], cim[b_of[ri], nc[ri], j]
                ar, ai = xr[r - j], xi[r - j]
                yre = yre + (ar * cr - ai * ci)
                yim = yim + (ar * ci + ai * cr)
            Y[ri, 0:2 * K:2] = torch.where(live[ri], yre, 0.0)
            Y[ri, 1:2 * K:2] = torch.where(live[ri], yim, 0.0)
        yh, yl = split(Y)
        out = torch.zeros(B, N, P, **f32)
        nxt = torch.zeros(frames, lay.P8, **f32)
        for t0 in range(0, Mr, rows - 1):
            V = gemm(tile(yh, t0, rows), tile(yl, t0, rows), Gh, Gl)
            rr = torch.arange(rows - 1)
            rr = rr[t0 + rr < Mr]
            ri = t0 + rr
            ok = (m_of[ri] >= 0) & (m_of[ri] < N)
            rr, ri = rr[ok], ri[ok]
            for j in range(lay.n_ctile):
                p = j * lay.w + pl
                pk = p < P
                cj = j * lay.bn_i + col[pk]
                val = (V[rr][:, cj] + V[rr + 1][:, cj + 8]) * weights[s]
                out[b_of[ri][:, None], m_of[ri][:, None], p[pk]] = val
                nxt[(b_of[ri] * Np + lay.pre + m_of[ri])[:, None],
                    p[pk]] = val
        y = y + a[s] * out
        sh, sl = split(nxt)
    return y.reshape(B, T)


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("chunked,B,N,P,M,S,advance", [
    (True, 2, 7, 16, 39, 4, 0), (True, 2, 6, 12, 50, 3, 2),
    (False, 1, 5, 16, 30, 3, 5), (False, 2, 4, 40, 79, 3, 0),
    (True, 4, 100, 80, 199, 3, 0), (True, 2, 12, 16, 239, 3, 0),
    (False, 2, 5, 16, 30, 3, 50)])
def test_kernel_plans_and_indexing_reproduce_the_twin(
        precision, chunked, B, N, P, M, S, advance):
    """The layout each entry reads reproduces the twin in the same
    arithmetic (``_tc_emulated``): the chunked entry's at Q = 3 (one and
    two batch rows a forward tile at P = 16 and 12; the flagship's P = 80,
    M = 199 with four row tiles across four batch rows) and Q = 15, the
    unchunked entry's (also at r0 = 0, an advance past P + M: no zero
    frame before a batch row, one more after it); within 1e-5 of max|y| at
    HIGH; at DEFAULT, where a
    value one fp32 step apart may round to another bf16, within 3e-3
    (readings 1e-4 to 1.3e-3)."""
    x, c, weights, a = _t(*_case(B, N, P, M, S))
    if chunked:
        nfft = lane_aligned_nfft(3 * P)
        want = taylor_cascade_chunked(x, c, weights, a, P, advance, nfft,
                                      precision)
    else:
        nfft = lane_aligned_nfft(2 * P + M + 1)
        want = taylor_cascade_unchunked(x, c, weights, a, P, advance, nfft,
                                        precision)
    got = _tc_emulated(x, c, weights, a, P, advance, nfft, precision,
                       chunked)
    assert _rel(got, want) <= (1e-5 if precision == "HIGH" else 3e-3)


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
@pytest.mark.parametrize("B,N,P,M,S,advance", [(4, 50, 240, 199, 20, 0),
                                               (2, 13, 16, 39, 4, 0),
                                               (3, 9, 18, 50, 3, 3),
                                               (2, 40, 80, 79, 5, 0)])
def test_unchunked_layout_reproduces_the_twin(precision, B, N, P, M, S,
                                              advance):
    """The unchunked entry's layout and tile walk at the four geometries
    of its card test (tests/test_torch_gpu.py:
    test_tc_cascade_unchunked_matches_twin, the same transform lengths):
    [chain48]'s P = 240 (two row tiles, the halo across them), K = 65 (the
    bins padded to 96), P = 18 (frames padded to 24) with advance > 0, and
    P = 80; against the twin within the card's bars (HIGH 2e-5, DEFAULT
    3e-3 of max|y|)."""
    x, c, weights, a = _t(*_case(B, N, P, M, S))
    nfft = (lane_aligned_nfft(2 * P + M + 1) if P >= 80
            else 1 << int(np.ceil(np.log2(2 * P + M + 1))))
    want = taylor_cascade_unchunked(x, c, weights, a, P, advance, nfft,
                                    precision)
    got = _tc_emulated(x, c, weights, a, P, advance, nfft, precision,
                       False)
    assert _rel(got, want) <= (2e-5 if precision == "HIGH" else 3e-3)


def test_unchunked_plans_hold_the_folded_plans():
    """The unchunked plans, unswizzled, hold split_plans' halves: the
    forward's rows Ffwd's re and im columns of the bins of forward_bins
    (each bin's two parts once) at context positions r P8 + q, the
    inverse's rows Ginv's columns of inverse_columns, zeros elsewhere;
    swizzle128 is a permutation of each row's 16-byte chunks."""
    nfft, m, p, advance = 128, 50, 18, 3
    f_hi, f_lo, g_hi, g_lo, r0, n_blk, K, lay = mlsa.tc_plans(
        nfft, m, p, advance, "HIGH", "cpu")
    fwd, (gre_h, gre_l), (gim_h, gim_l), r0_, n_blk_ = split_plans(
        nfft, m, p, advance, "cpu")
    assert (r0, n_blk) == (r0_, n_blk_) and lay.P8 == 24 and lay.Kp == 96
    for img, half in ((f_hi, 0), (f_lo, 1)):
        Ft = mlsa.unswizzle128(img).float()
        grid = Ft[:, :lay.kf].reshape(lay.Nf, n_blk, lay.P8)
        kb, part = mlsa.forward_bins(lay)
        live = kb < K
        for r in range(n_blk):
            want = fwd[r][half]                              # (P, 2K)
            assert torch.equal(grid[live, r, :p],
                               want[:, (part * K + kb)[live]].T)
        assert not grid[:, :, p:].any() and not Ft[~live].any()
        assert not Ft[:, lay.kf:].any()
    held = sorted((part * K + kb)[live].tolist())
    assert held == list(range(2 * K))
    src = mlsa.inverse_columns(lay, p)
    for img, (re, im) in ((g_hi, (gre_h, gim_h)), (g_lo, (gre_l, gim_l))):
        Gt = mlsa.unswizzle128(img).float()
        live = src >= 0
        assert torch.equal(Gt[live, 0:2 * K:2], re.T[src[live]])
        assert torch.equal(Gt[live, 1:2 * K:2], im.T[src[live]])
        assert not Gt[~live].any() and not Gt[:, 2 * K:].any()
    t = torch.arange(16 * 128, dtype=torch.float32).reshape(16, 128)
    img = mlsa.swizzle128(t)
    assert torch.equal(mlsa.unswizzle128(img), t)
    assert torch.equal(img[0, 3, 8:16], t[3, 16:24])   # chunk 2 of row 3


def _chunked_geometry_of(P, advance):
    """r0, n_blk and K of the chunked entry's plan at frame period P:
    ``cascade_plan(lane_aligned_nfft(3P), P - 1, P, advance)``'s, by its
    arithmetic alone (the plans themselves are not built)."""
    K = lane_aligned_nfft(3 * P) // 2 + 1
    padl = 2 * P - 1 - advance
    r0 = -(-padl // P)
    n_blk = -(-(r0 * P - padl + 3 * P - 1) // P)
    return r0, n_blk, K


def _parent_rows(P, Q, r0, n_blk, K, high):
    """The rows a block of the chunked entry's mma.sync kernel (the parent
    of the wgmma design) took at a geometry, 0 where it refused it: its
    run_cascade's check r0 >= 0, then its choose_rows and smem_bytes,
    written out.  A block of 32 rows, else 16, needed rows - Q >= 1 frames
    and its bf16 operand rows (hi, and lo at HIGH; lda bf16 a row) and
    fp32 X rows (ldx floats a row) within the 232,448 bytes of shared
    memory a block may use."""
    def up(v, m):
        return -(-v // m) * m
    if r0 < 0:
        return 0
    kc1, kp, n2 = up(n_blk * P, 16), up(K, 16), up(2 * P, 32)
    lda = max(kc1, 2 * kp) + 8
    ldx = max(2 * kp, n2) + 4
    for rows in (32, 16):
        smem = (2 if high else 1) * rows * lda * 2 + rows * ldx * 4
        if rows - Q >= 1 and smem <= 232448:
            return rows
    return 0


def test_chunked_entry_takes_every_geometry_the_parent_took():
    """Every (P, Q) of P in 1 .. 800 (the parent took P up to 767) and Q in
    2 .. 31, at advance 0 and 3, that the parent's rule took at an arm has
    a layout under the new entry (``mlsa.tc_layout``), whose tile walk
    covers every row; the new entry also takes Q up to ``TC_MAX_Q``.  The
    geometry's arithmetic agrees with ``cascade_plan`` where it is cheap to
    build."""
    for P, advance in ((1, 0), (16, 5), (80, 0), (81, 3)):
        plan = cascade_plan(lane_aligned_nfft(3 * P), P - 1, P, advance)
        assert _chunked_geometry_of(P, advance) == (
            plan[3], plan[4], lane_aligned_nfft(3 * P) // 2 + 1)
    taken = 0
    for advance in (0, 3):
        for P in range(1, 801):
            r0, n_blk, K = _chunked_geometry_of(P, advance)
            for precision in ("HIGH", "DEFAULT"):
                for Q in range(2, 32):
                    if not _parent_rows(P, Q, r0, n_blk, K,
                                        precision == "HIGH"):
                        continue
                    taken += 1
                    lay = mlsa.tc_layout(P, Q, r0, n_blk, K, precision,
                                         True)
                    assert lay is not None, (P, Q, advance, precision)
                    assert lay.pre == Q - 1 + r0 >= 1
                    # frame N's context ends in the next row's zeros
                    assert lay.after >= 0 and lay.pre + lay.after >= 1
    assert taken > 40000
    assert mlsa.tc_layout(80, mlsa.TC_MAX_Q, 2, 3, 128, "HIGH", True)
    assert mlsa.tc_layout(80, mlsa.TC_MAX_Q + 1, 2, 3, 128, "HIGH",
                          True) is None


@pytest.mark.parametrize("P,M,advance", [(16, 39, 0), (16, 30, 5),
                                         (32, 63, 0)])
def test_default_twin_is_live_and_near_float64(P, M, advance):
    """DEFAULT on both branches against float64, and not the fp32 result;
    HIGH within 1e-5.  DEFAULT's distance moves with the draw: over 40
    draws of these cases its median is 1.1e-3 to 1.5e-3 of max|y|, its
    largest 2.54e-3 at the lane-aligned transform length that the MGLSA
    filter takes (held within 3e-3) and 3.25e-3 at the shortest one,
    2P+M+1 (held within 4e-3).  Each case draws from its own seed."""
    rng = np.random.default_rng(1000 * P + M + advance)
    x, c, weights, a = _case(3, 5, P, M, 4, rng=rng)
    t32 = _t(x, c, weights, a)
    t64 = [t.double() for t in t32]
    for nfft, bar in ((lane_aligned_nfft(2 * P + M + 1), 3e-3),
                      (2 * P + M + 1, 4e-3)):
        want = taylor_cascade_folded(*t64, P, advance, nfft)
        full = taylor_cascade_folded(*t32, P, advance, nfft)
        low = taylor_cascade_folded(*t32, P, advance, nfft, "DEFAULT")
        high = taylor_cascade_folded(*t32, P, advance, nfft, "HIGH")
        assert _rel(low, want) <= bar
        assert _rel(high, want) <= 1e-5
        assert _rel(low, full) > 1e-5 and not torch.equal(high, full)


def test_none_and_highest_are_the_fp32_form_bit_for_bit():
    """None and "HIGHEST" change nothing: the folded form, the kernel
    wrapper's CPU path and the branches' default are one computation."""
    for P, M in ((16, 39), (16, 30)):
        x, c, weights, a = _t(*_case(2, 5, P, M, 3))
        nfft = lane_aligned_nfft(2 * P + M + 1)
        ref = taylor_cascade_folded(x, c, weights, a, P, 0, nfft)
        for got in (taylor_cascade_folded(x, c, weights, a, P, 0, nfft,
                                          "HIGHEST"),
                    mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft),
                    mlsa.taylor_cascade(x, c, weights, a, P, 0, nfft,
                                        "HIGHEST")):
            assert torch.equal(got, ref)


def test_float64_ignores_precision():
    x, c, weights, a = _t(*_case(2, 5, 16, 39, 3, np.float64))
    nfft = lane_aligned_nfft(2 * 16 + 40)
    ref = taylor_cascade_folded(x, c, weights, a, 16, 0, nfft, "HIGHEST")
    for precision in ("HIGH", "DEFAULT"):
        assert torch.equal(
            taylor_cascade_folded(x, c, weights, a, 16, 0, nfft, precision),
            ref)
        assert torch.equal(
            mlsa.taylor_cascade(x, c, weights, a, 16, 0, nfft, precision),
            ref)


def test_backward_is_the_fp32_form_at_every_precision():
    """The forward's precision does not reach the backward (as the JAX
    VJP differentiates the folded form whatever the forward's)."""
    x, c, weights, a = _t(*_case(2, 5, 16, 39, 3))
    nfft = lane_aligned_nfft(2 * 16 + 40)
    g = torch.as_tensor(RNG.standard_normal(x.shape), dtype=torch.float32)
    grads = []
    for precision in ("HIGHEST", "HIGH", "DEFAULT"):
        xg = x.clone().requires_grad_(True)
        cg = c.clone().requires_grad_(True)
        mlsa.taylor_cascade(xg, cg, weights, a, 16, 0, nfft,
                            precision).backward(g)
        grads.append((xg.grad, cg.grad))
    for dx, dc in grads[1:]:
        assert torch.equal(dx, grads[0][0]) and torch.equal(dc, grads[0][1])


def test_bad_precision_raises():
    x, c, weights, a = _t(*_case(1, 4, 16, 39, 2))
    with pytest.raises(ValueError):
        mlsa.taylor_cascade(x, c, weights, a, 16, 0, 96, "LOW")
    with pytest.raises(ValueError):
        taylor_cascade_folded(x, c, weights, a, 16, 0, 96, "LOW")
    with pytest.raises(ValueError):
        pt.MLSA(4, 16, cep_order=39, cascade="fused",
                cascade_precision="LOW", **F32)


@pytest.mark.parametrize("cascade", ["fused", "folded"])
@pytest.mark.parametrize("precision", ["HIGHEST", "HIGH", "DEFAULT"])
def test_mlsa_module_at_each_precision(cascade, precision):
    """PseudoMGLSADigitalFilter at the flagship's order (cep_order 199,
    P 80, Taylor order 20) against the JAX module in float32."""
    B, N, P = 2, 4, 80
    x = RNG.standard_normal((B, N * P)).astype(np.float32)
    mc = (RNG.standard_normal((B, N, 25)) * 0.1).astype(np.float32)
    kw = dict(alpha=0.42, cep_order=199, taylor_order=20, cascade=cascade,
              cascade_precision=precision)
    want = np.asarray(JMLSA(24, P, **kw)(jnp.asarray(x), jnp.asarray(mc)))
    got = pt.MLSA(24, P, **kw, **F32)(*_t(x, mc))
    assert _rel(got, want) <= (3e-3 if precision == "DEFAULT" else 1e-4)


@pytest.fixture(scope="module")
def vocoder_case():
    """Two rows of 1,600 samples of synthetic speech, an excitation, and
    the JAX vocoder's float32 mc, round trip and synthesis (jitted)."""
    import jax

    from chip_smoke import synth_speech
    from diffsptk_tpu.models.mcep_vocoder import (
        MelCepstralVocoder as JVocoder,
    )

    x = synth_speech(2, 1600).astype(np.float32)
    e = RNG.standard_normal(x.shape).astype(np.float32)
    kw = dict(cascade="fused", n_iter=3)
    voc = JVocoder(**kw)
    mc = jax.jit(voc.analyze)(jnp.asarray(x))
    want = {"analysis_synthesis": np.asarray(
                jax.jit(voc.analysis_synthesis)(jnp.asarray(x))),
            "synthesize": np.asarray(
                jax.jit(voc.synthesize)(jnp.asarray(e), mc))}
    return x, e, np.asarray(mc, np.float32), kw, want


# max|y| bars of the vocoder against the JAX vocoder (float32 on the CPU
# at every precision).  The round trip's inverse filter cancels Taylor
# terms far larger than its result, so it amplifies rounding: HIGHEST
# reads 5.1e-4 to 6.6e-4 (the repo's float32 round-trip bar is 1e-2,
# chip_smoke.py's [chain]), HIGH 7.4e-3 to 1.2e-2; at DEFAULT the round
# trip does not hold (5.8 to 7.7 of max|y|), as the JAX package's
# docstring warns, so only its single synthesis pass is held (4.8e-3 to
# 5.9e-3).  One synthesis pass at HIGHEST and HIGH reads 1.6e-6, 8.2e-6.
VOCODER_BARS = {("analysis_synthesis", "HIGHEST"): 1e-2,
                ("analysis_synthesis", "HIGH"): 3e-2,
                ("synthesize", "HIGHEST"): 1e-4,
                ("synthesize", "HIGH"): 1e-4,
                ("synthesize", "DEFAULT"): 2e-2}


@pytest.mark.parametrize("method,precision", list(VOCODER_BARS))
def test_vocoder_at_each_precision(vocoder_case, method, precision):
    """MelCepstralVocoder (cascade "fused") at the flagship's settings,
    float32, against the JAX vocoder."""
    x, e, mc, kw, want = vocoder_case
    voc = pt.MelCepstralVocoder(**kw, cascade_precision=precision, **F32)
    args = ((x,) if method == "analysis_synthesis" else (e, mc))
    got = getattr(voc, method)(*_t(*args))
    assert _rel(got, want[method]) <= VOCODER_BARS[method, precision]
