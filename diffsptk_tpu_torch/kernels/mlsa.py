"""Taylor MLSA cascade: hand-written CUDA kernels and autograd Function
(counterpart of ``diffsptk_tpu/kernels/pallas_mlsa.py``).

On a CUDA float32 tensor the S stages run as S launches, enqueued by one
call, the (B, N, P) state in two ping-pong buffers, through an entry for
the tap-chunked geometry (the B2 row) where the folded form takes the
chunked branch and through another otherwise (B3).  ``precision`` picks
the kernel, as it picks the TPU kernel:

* ``"HIGHEST"``: the direct fp32 FIR of ``csrc/mlsa_cascade.cu``;
* ``"HIGH"`` (bf16x3) and ``"DEFAULT"`` (one bf16 pass): the DFT-plan
  form on the tensor cores, ``csrc/mlsa_cascade_tc.cu``.  A request at
  these settings runs that kernel or raises; it never falls back.

On a CPU tensor, or inside ``twins()``, the cascade is its plain twin,
``mlsa_cascade.taylor_cascade_folded``, in the same arithmetic.  The
backward is the folded fp32 form at every precision, as the JAX VJP is.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import build
from .mlsa_cascade import (
    PRECISIONS,
    _coef_spectrum_tensors,
    cascade_plan,
    chunk_split,
    chunked_geometry,
    split_hi_lo,
    taylor_cascade_folded,
)
from .state import use_twins

launches = 0
"""Launches of the fp32 cascade kernel through the tap-chunked entry so
far, one per stage (the twin does not count)."""

launches_unchunked = 0
"""Launches through the fp32 kernel's unchunked entry so far, one per
stage."""

launches_high = 0
"""Launches of the tensor-core kernel at "HIGH" through its tap-chunked
entry so far, one per stage."""

launches_default = 0
"""The same at "DEFAULT"."""

launches_high_unchunked = 0
"""Stages run by the tensor-core kernel at "HIGH" through its unchunked
entry so far, one per stage (each stage is two launches, the forward and
the inverse product, after one prologue launch a call)."""

launches_default_unchunked = 0
"""The same at "DEFAULT"."""


@functools.cache
def _entry(name: str, defines=()):
    fn = getattr(build.library("mlsa_cascade", defines), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def tile(P: int, M: int):
    """The kernel's tile at frame period P and filter order M: (frames
    per block, threads per block, shared memory bytes), or None where one
    frame does not fit in a block's shared memory."""
    fn = build.library("mlsa_cascade").mlsa_cascade_tile
    frames, threads = ctypes.c_int(0), ctypes.c_int(0)
    nbytes = fn(P, M, ctypes.byref(frames), ctypes.byref(threads))
    return None if nbytes < 0 else (frames.value, threads.value, nbytes)


def _checked(x, c, weights, a, P: int):
    """Check the arguments of a cascade kernel's entry: (B, N, M, S) and
    the weights and Taylor coefficients as float32 on x's device."""
    if not (x.is_cuda and c.is_cuda):
        raise ValueError("the cascade kernel takes CUDA tensors")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError("the cascade kernel takes float32")
    B, N, P_ = x.shape
    if P_ != P or c.shape[:2] != (B, N):
        raise ValueError(
            f"x must be (B, N, P) and c (B, N, M+1); got {tuple(x.shape)} "
            f"and {tuple(c.shape)}")
    if weights.shape != a.shape or weights.ndim != 1:
        raise ValueError("weights and a must both be (S+1,)")
    w, a = (t.to(device=x.device, dtype=torch.float32).contiguous()
            for t in (weights, a))
    return (B, N, c.shape[-1] - 1, weights.shape[0] - 1), w, a


def _run(entry: str, x, c, weights, a, P: int, advance: int, defines=()):
    """Check the arguments and enqueue the S stages through ``entry``;
    returns (y, S)."""
    (B, N, M, S), w, a = _checked(x, c, weights, a, P)
    if S == 0:
        return a[0] * x, 0
    with torch.cuda.device(x.device):
        if tile(P, M) is None:
            raise ValueError(
                f"the cascade kernel cannot hold one frame of P={P}, M={M} "
                "in a block's shared memory")
        x, c = x.contiguous(), c.contiguous()
        # the kernel reads x, and c where rows allow, 16 bytes at a time
        x, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, c))
        buf = x.new_empty((2,) + x.shape)       # the stages' ping-pong
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(entry, tuple(defines))(
            x.data_ptr(), c.data_ptr(), w.data_ptr(), a.data_ptr(),
            buf.data_ptr(), y.data_ptr(), B, N, P, M, advance, S, stream)
    build.check(err, "mlsa_cascade stage")
    return y, S


@span("kernel.mlsa.chunked")
def cascade_chunked_cuda(x: torch.Tensor, c: torch.Tensor,
                         weights: torch.Tensor, a: torch.Tensor, P: int,
                         advance: int, nfft_c: int,
                         _defines=()) -> torch.Tensor:
    """The cascade on the card at the tap-chunked geometry (the B2 row).

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P).  nfft_c,
    the folded form's chunk transform length, is only checked: the kernel
    needs no transform.  Raises on what the kernel does not take.
    ``_defines`` builds the kernel with those macros set: the variants of
    tools/torch_cascade_ablation.py (the one without its tap loop computes
    wrong values and only times what remains).
    """
    global launches
    if nfft_c < 3 * P:
        raise ValueError(f"nfft_c must be at least 3P = {3 * P}")
    y, S = _run("mlsa_cascade_stage_f32", x, c, weights, a, P, advance,
                _defines)
    launches += S
    return y


@span("kernel.mlsa.unchunked")
def cascade_unchunked_cuda(x: torch.Tensor, c: torch.Tensor,
                           weights: torch.Tensor, a: torch.Tensor, P: int,
                           advance: int, nfft: int) -> torch.Tensor:
    """The cascade on the card at every other geometry (the B3 row).

    x (B, N, P) float32, c (B, N, M+1) float32 -> y (B, N, P).  nfft, the
    folded form's transform length, is only checked (>= 2P+M+1).  Raises
    on what the kernel does not take.
    """
    global launches_unchunked
    M = c.shape[-1] - 1
    if nfft < 2 * P + M + 1:
        raise ValueError(f"nfft must be at least 2P+M+1 = {2 * P + M + 1}")
    y, S = _run("mlsa_cascade_unchunked_stage_f32", x, c, weights, a, P,
                advance)
    launches_unchunked += S
    return y


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.cache
def _tc_entry(name: str, defines=()):
    fn = getattr(build.library("mlsa_cascade_tc", defines), name)
    n_int = 8 if "unchunked" in name else 9
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The tensor-core kernels' tiles (csrc/mlsa_cascade_tc.cu, namespace wg):
# rows of a tile, K of a ring stage, and at each arm and entry (chunked or
# not) the columns of the forward and the inverse tile.  The C layout is
# held equal to tc_layout's at a geometry's first call.
TC_TILE_ROWS = 128
TC_BK = 64
TC_TILE_COLUMNS = {("HIGH", False): (128, 128), ("DEFAULT", False): (192, 240),
                   ("HIGH", True): (128, 80), ("DEFAULT", True): (128, 80)}
TC_PLAN_BUDGET = 24 << 20
"""Bytes of plans (both products, both halves at HIGH) that the
unchunked entry takes at most: its row tiles re-read them from L2."""
TC_MAX_Q = 64
"""Tap chunks the chunked entry takes at most: a forward tile of
TC_TILE_ROWS rows yields TC_TILE_ROWS + 1 - Q rows of Y."""


class TcLayout(NamedTuple):
    """The tensor-core entries' layout of a geometry at one arm."""

    P8: int       # a frame's width in the padded state: P rounded up to 8
    kf: int       # the forward contraction, n_blk P8
    Kf: int       # and rounded up to TC_BK
    Kp: int       # bins rounded up to 32 (Y and the inverse plan: 2 Kp)
    Nf: int       # forward plan rows: 2 Kp rounded up to the tile
    bn_f: int     # forward tile columns
    bn_i: int     # inverse tile columns
    w: int        # frame columns p a tile of the inverse (bn_i / 2)
    n_ctile: int  # column tiles of the inverse
    Ni: int       # inverse plan rows, n_ctile bn_i
    pre: int      # zero frames before each batch row, Q - 1 + r0
    after: int    # and after it: n_blk - 1 - r0, one more where pre = 0


def tc_layout(P: int, Q: int, r0: int, n_blk: int, K: int, precision: str,
              chunked: bool = False):
    """The tensor-core entry's layout at frame period P, Q tap chunks (1
    for the unchunked entry), r0, n_blk and K bins: a :class:`TcLayout`,
    or None where the entry refuses the geometry (Q outside 1 ..
    ``TC_MAX_Q``, r0 outside 0 .. n_blk - 1, or unchunked plans past
    ``TC_PLAN_BUDGET``).  A batch row holds pre + N + after padded frames;
    its row i is frame i - (Q - 1)."""
    bn_f, bn_i = TC_TILE_COLUMNS[precision, chunked]
    P8 = _round_up(P, 8)
    Kp = _round_up(K, 32)
    w = bn_i // 2
    n_ctile = -(-P // w)
    pre = Q - 1 + r0
    lay = TcLayout(P8, n_blk * P8, _round_up(n_blk * P8, TC_BK), Kp,
                   _round_up(2 * Kp, bn_f), bn_f, bn_i, w, n_ctile,
                   n_ctile * bn_i, pre, n_blk - 1 - r0 + (pre == 0))
    halves = 2 if precision == "HIGH" else 1
    plans = (lay.Nf * lay.Kf + lay.Ni * 2 * Kp) * 2 * halves
    if (not 1 <= Q <= TC_MAX_Q or not 0 <= r0 <= n_blk - 1
            or (not chunked and plans > TC_PLAN_BUDGET)):
        return None
    return lay


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """A (R, Kc) K-major operand (R a multiple of 8, Kc of TC_BK) as the
    kernel's ring stages hold it: (Kc / 64, R, 64), the 16-byte chunk c of
    row n at chunk c ^ (n % 8) (wgmma's 128-byte swizzle)."""
    R, Kc = t.shape
    t4 = t.reshape(R, Kc // TC_BK, 8, 8).permute(1, 0, 2, 3)
    src = torch.arange(8)[None, :] ^ (torch.arange(R)[:, None] % 8)
    return t4.gather(2, src[None, :, :, None].expand(t4.shape)).reshape(
        Kc // TC_BK, R, TC_BK)


def unswizzle128(img: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`swizzle128`: (Kc / 64, R, 64) -> (R, Kc)."""
    KB, R, _ = img.shape
    t4 = img.reshape(KB, R, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(R)[:, None] % 8)
    t4 = t4.gather(2, src[None, :, :, None].expand(t4.shape))
    return t4.permute(1, 0, 2, 3).reshape(R, KB * TC_BK)


def forward_bins(lay: TcLayout) -> tuple[torch.Tensor, torch.Tensor]:
    """For each of the forward plan's Nf rows (the product's columns), the
    bin and the part (0 re, 1 im) it computes: column 32 g + 8 jj + 2 t + e
    holds part e of bin 16 g + 4 t + jj, so that the thread holding
    columns 8 j + 2 t + e of a wgmma tile (t = lane % 4) holds four
    consecutive bins."""
    c = torch.arange(lay.Nf)
    g, cc = c // 32, c % 32
    return 16 * g + 4 * ((cc % 8) // 2) + cc // 8, cc % 2


def inverse_columns(lay: TcLayout, P: int) -> torch.Tensor:
    """For each of the inverse plan's Ni rows (the product's columns), the
    column of ``cascade_plan``'s Ginv it holds, or -1 (zero): tile j's
    columns in groups of 8, lo (1 - lam) of p, then hi lam of the same p
    (Ginv column P + p), for p = j w + 8 g .. j w + 8 g + 7."""
    c = torch.arange(lay.Ni)
    j, cc = c // lay.bn_i, c % lay.bn_i
    q, e = cc // 8, cc % 8
    p = j * lay.w + (q // 2) * 8 + e
    return torch.where(p < P, p + (q % 2) * P, -1)


@functools.lru_cache(maxsize=16)
def tc_plans(nfft: int, m: int, p: int, advance: int, precision: str,
             device, Q: int = 1, chunked: bool = False):
    """The tensor-core entry's plans for a geometry at one arm, made once
    per device: (f_hi, f_lo, g_hi, g_lo, r0, n_blk, K, layout), or None
    where the entry refuses the geometry.  The chunked entry's are those of
    ``cascade_plan(nfft_c, P - 1, P, advance)``, with Q its tap chunks.

    The forward plan, transposed (Nf, Kf): row c holds the part of the
    bin that :func:`forward_bins` gives it, over the context position
    r P8 + q (``cascade_plan``'s Ffwd[r, q], zero for q >= P).  The
    inverse plan, transposed (Ni, 2 Kp): row c holds the Ginv column of
    :func:`inverse_columns`, over Y's columns (bin k's re at 2k, its im at
    2k + 1).  Each is rounded to float32, split exactly into bf16 hi and lo
    (``mlsa_cascade.split_hi_lo``) and laid out as :func:`swizzle128`."""
    Ffwd, Ginv_re, Ginv_im, r0, n_blk = cascade_plan(nfft, m, p, advance)
    K = nfft // 2 + 1
    lay = tc_layout(p, Q, r0, n_blk, K, precision, chunked)
    if lay is None:
        return None
    f64 = torch.float64
    fwd = torch.as_tensor(Ffwd, dtype=f64)                 # (n_blk, P, 2K)
    f = torch.zeros(lay.Nf, n_blk, lay.P8, dtype=f64)
    k, e = forward_bins(lay)
    live = k < K
    f[live, :, :p] = fwd[..., (e * K + k)[live]].permute(2, 0, 1)
    f = torch.cat([f.reshape(lay.Nf, lay.kf),
                   torch.zeros(lay.Nf, lay.Kf - lay.kf, dtype=f64)], 1)
    src = inverse_columns(lay, p)
    live = src >= 0
    g = torch.zeros(lay.Ni, 2 * lay.Kp, dtype=f64)
    g[live, 0:2 * K:2] = torch.as_tensor(Ginv_re).T[src[live]]
    g[live, 1:2 * K:2] = torch.as_tensor(Ginv_im).T[src[live]]
    out = []
    for plan in (f, g):
        out += [swizzle128(h.to(torch.bfloat16)).to(device)
                for h in split_hi_lo(plan.float())]
    return (*out, r0, n_blk, K, lay)


@functools.cache
def _tc_c(P: int, Q: int, r0: int, n_blk: int, K: int, precision: str,
          chunked: bool):
    """The C side's layout of a geometry (``mlsa_cascade_tc_layout``): (the
    TcLayout fields, shared memory bytes of the forward and the inverse
    kernel, ring stages of each), or None where it refuses the
    geometry."""
    fn = build.library("mlsa_cascade_tc").mlsa_cascade_tc_layout
    fn.restype = ctypes.c_longlong
    out = (ctypes.c_int * 16)()
    nbytes = fn(P, Q, r0, n_blk, K, int(precision == "HIGH"), int(chunked),
                out)
    return None if nbytes < 0 else tuple(out)


@functools.cache
def tc_tile(P: int, Q: int, r0: int, n_blk: int, K: int, precision: str,
            chunked: bool = False):
    """An entry's tiles at one arm, as its C side reports them: a dict of
    rows a tile, the forward tiles' row step, the forward and inverse
    tiles' columns, ring stages, shared memory bytes and blocks that fit
    on one SM, or None where it refuses the geometry."""
    got = _tc_c(P, Q, r0, n_blk, K, precision, chunked)
    if got is None:
        return None
    fn = build.library("mlsa_cascade_tc").mlsa_cascade_tc_occupancy
    occ = (ctypes.c_int * 2)()
    fn(int(precision == "HIGH"), int(chunked), occ)
    lay = TcLayout(*got[:12])
    return dict(rows=TC_TILE_ROWS, fwd_step=TC_TILE_ROWS + 1 - Q,
                fwd_cols=lay.bn_f, inv_cols=lay.bn_i, fwd_stages=got[14],
                inv_stages=got[15], fwd_smem=got[12], inv_smem=got[13],
                fwd_per_sm=occ[0], inv_per_sm=occ[1], layout=lay)


@functools.lru_cache(maxsize=16)
def _coef_plan_cat(nfft: int, n_taps: int, device):
    """``coef_spectrum``'s cos and -sin plans side by side, (n_taps, 2K)
    float32 on ``device``."""
    return torch.cat(_coef_spectrum_tensors(nfft, n_taps, torch.float32,
                                            device), -1)


def coef_spectrum_cat(c: torch.Tensor, nfft: int) -> torch.Tensor:
    """``coef_spectrum``'s re and im in one (..., 2K) array (re at k, im
    at K + k), by one matmul: what the tensor-core entries read.  The same
    sums as coef_spectrum's two matmuls, column for column."""
    return torch.matmul(c, _coef_plan_cat(nfft, c.shape[-1], c.device))


@functools.cache
def _tc_workspace_fn():
    fn = build.library("mlsa_cascade_tc").mlsa_cascade_tc_workspace
    fn.restype = ctypes.c_longlong
    return fn


def _run_tc(x, c, weights, a, P: int, advance: int, nfft: int,
            precision: str, chunked: bool, defines=()):
    """Check the arguments and enqueue the S stages of the tensor-core
    kernels (built with ``defines``) through the chunked (transform length
    ``nfft`` = nfft_c) or the unchunked entry; returns (y, S)."""
    if precision not in ("HIGH", "DEFAULT"):
        raise ValueError('the tensor-core cascade takes "HIGH" or "DEFAULT"')
    (B, N, M, S), w, a = _checked(x, c, weights, a, P)
    if S == 0:
        return a[0] * x, 0
    with torch.cuda.device(x.device):
        if chunked:
            taps, Q = chunk_split(c, P)                  # (B, N, Q, P)
            m = P - 1
        else:
            taps, Q, m = c, 1, M
        plan = tc_plans(nfft, m, P, advance, precision, x.device, Q, chunked)
        if plan is None:
            raise ValueError(
                f"the tensor-core cascade has no tile for P={P}, M={M}, "
                f"Q={Q}, nfft={nfft}: "
                + ("its Q passes " + str(TC_MAX_Q) if chunked else
                   f"its plans pass {TC_PLAN_BUDGET >> 20} MB")
                + " or its frames' context starts after the frame")
        f_hi, f_lo, g_hi, g_lo, r0, n_blk, K, lay = plan
        high = int(precision == "HIGH")
        got = _tc_c(P, Q, r0, n_blk, K, precision, chunked)
        if got is None or got[:12] != lay:
            raise RuntimeError(
                "mlsa_cascade_tc.cu's layout differs from tc_layout's")
        cre = coef_spectrum_cat(taps, nfft)         # (B, N, [Q,] 2K)
        cim = cre[..., K:]
        nbytes = _tc_workspace_fn()(B, N, P, Q, r0, n_blk, K, high,
                                    int(chunked))
        if nbytes < 0:
            raise ValueError(
                f"the tensor-core cascade has no tile for B={B}, N={N} "
                f"at P={P}: its indices pass 2^31")
        buf = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        x = x.contiguous()
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [t.data_ptr() for t in (x, cre, cim, f_hi, f_lo, g_hi, g_lo,
                                       w, a, buf, y)]
        if chunked:
            entry, ints = "mlsa_cascade_tc_chunked_f32", [B, N, P, Q, r0,
                                                          n_blk, K]
        else:
            entry, ints = "mlsa_cascade_tc_unchunked_f32", [B, N, P, r0,
                                                            n_blk, K]
        err = _tc_entry(entry, tuple(defines))(*ptrs, *ints, S, high, stream)
    build.check(err, "mlsa_cascade_tc stage")
    return y, S


@span("kernel.mlsa.chunked_tc")
def cascade_chunked_tc_cuda(x: torch.Tensor, c: torch.Tensor,
                            weights: torch.Tensor, a: torch.Tensor, P: int,
                            advance: int, nfft_c: int, precision: str,
                            _defines=()) -> torch.Tensor:
    """The cascade on the card's tensor cores at "HIGH" or "DEFAULT", at
    the tap-chunked geometry (the B2 row) with chunk transform length
    ``nfft_c``.  x (B, N, P) float32, c (B, N, M+1) float32 ->
    y (B, N, P).  Raises on what the kernel does not take.  ``_defines``
    as :func:`cascade_unchunked_tc_cuda`'s."""
    global launches_high, launches_default
    if nfft_c < 3 * P:
        raise ValueError(f"nfft_c must be at least 3P = {3 * P}")
    y, S = _run_tc(x, c, weights, a, P, advance, nfft_c, precision, True,
                   _defines)
    if precision == "HIGH":
        launches_high += S
    else:
        launches_default += S
    return y


@span("kernel.mlsa.unchunked_tc")
def cascade_unchunked_tc_cuda(x: torch.Tensor, c: torch.Tensor,
                              weights: torch.Tensor, a: torch.Tensor, P: int,
                              advance: int, nfft: int, precision: str,
                              _defines=()) -> torch.Tensor:
    """The cascade on the card's tensor cores at "HIGH" or "DEFAULT", at
    every other geometry (the B3 row), transform length ``nfft``
    (>= 2P+M+1).  x (B, N, P) float32, c (B, N, M+1) float32 ->
    y (B, N, P).  Raises on what the kernel does not take.  ``_defines``
    builds the kernel with those macros set: the variants of
    tools/torch_tc_cascade_ab.py (MLSA_TC_NO_PDL launches without
    programmatic dependence; MLSA_TC_NO_PREFETCH leaves out the chunked
    inverse's L2 prefetch of the spectra; MLSA_TC_ABLATE_EPILOGUE and
    MLSA_TC_ABLATE_MMA leave out the epilogues or the products, compute
    wrong values and only time what remains)."""
    global launches_high_unchunked, launches_default_unchunked
    M = c.shape[-1] - 1
    if nfft < 2 * P + M + 1:
        raise ValueError(f"nfft must be at least 2P+M+1 = {2 * P + M + 1}")
    y, S = _run_tc(x, c, weights, a, P, advance, nfft, precision, False,
                   _defines)
    if precision == "HIGH":
        launches_high_unchunked += S
    else:
        launches_default_unchunked += S
    return y


def _cascade(x, c, weights, a, P, advance, nfft, precision="HIGHEST"):
    """The kernel of ``precision`` on the card, the folded twin in the
    same arithmetic on the CPU or in twins()."""
    M = c.shape[-1] - 1
    if not x.is_cuda or use_twins():
        return taylor_cascade_folded(x, c, weights, a, P, advance, nfft,
                                     precision)
    chunked = chunked_geometry(M, P, nfft)
    N = c.shape[-2]
    T = x.shape[-1]
    xb = x.reshape(-1, N, P)
    cb = torch.broadcast_to(c, x.shape[:-1] + c.shape[-2:]).reshape(
        -1, N, M + 1)
    if precision in ("HIGH", "DEFAULT"):
        if chunked is None:
            y = cascade_unchunked_tc_cuda(xb, cb, weights, a, P, advance,
                                          nfft, precision)
        else:
            y = cascade_chunked_tc_cuda(xb, cb, weights, a, P, advance,
                                        chunked[1], precision)
    elif chunked is None:
        y = cascade_unchunked_cuda(xb, cb, weights, a, P, advance, nfft)
    else:
        y = cascade_chunked_cuda(xb, cb, weights, a, P, advance, chunked[1])
    return y.reshape(x.shape[:-1] + (T,))


class TaylorCascade(torch.autograd.Function):
    """Forward: the kernel of ``precision`` on the card, the folded twin
    on the CPU.  Backward: autograd through the folded fp32 twin whatever
    the forward's precision (as the JAX VJP differentiates the folded XLA
    form)."""

    @staticmethod
    def forward(ctx, x, c, weights, a, P, advance, nfft, precision):
        ctx.save_for_backward(x, c, weights, a)
        ctx.geometry = (P, advance, nfft)
        return _cascade(x, c, weights, a, P, advance, nfft, precision)

    @staticmethod
    def backward(ctx, g):
        x, c, weights, a = ctx.saved_tensors
        P, advance, nfft = ctx.geometry
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (x, c, weights, a)]
            y = taylor_cascade_folded(*ins, P, advance, nfft)
            grads = torch.autograd.grad(y, ins, g, allow_unused=True)
        return (*grads, None, None, None, None)


def taylor_cascade(x, c, weights, a, P, advance, nfft, precision="HIGHEST"):
    """Fused Taylor-cascade MLSA filter.

    x (..., T); c (..., N, M+1) stage coefficients; weights/a (S+1,).
    ``precision``: "HIGHEST" (fp32), "HIGH" (bf16x3) or "DEFAULT" (one
    bf16 pass; about 1e-3 of max|y| from float64 for one synthesis pass,
    not for inverse-then-forward round trips, which re-amplify it).  The
    twin ignores it at float64; the kernels take float32 only.  Without a
    gradient to track, the call skips the autograd Function and its
    host-side bookkeeping.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, c, weights, a)):
        return TaylorCascade.apply(x, c, weights, a, P, advance, nfft,
                                   precision)
    return _cascade(x, c, weights, a, P, advance, nfft, precision)
