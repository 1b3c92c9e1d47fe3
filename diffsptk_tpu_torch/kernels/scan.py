"""First-order affine scan: hand-written CUDA kernel, plain twin and autograd
Function (counterpart of ``diffsptk_tpu/kernels/pallas_scan.py``).

y[t] = p[t] y[t-1] + x[t] (y[-1] = 0) over the last axis, real or complex.
On a CUDA float32 / complex64 tensor the scan is ``csrc/scan.cu``, one
launch that reads p and x once; on a CPU tensor it is
:func:`first_order_scan_plain`, a log-depth Hillis-Steele scan over T in
torch (the counterpart of JAX's associative scan).
:func:`first_order_scan_tiled` is the kernel's own order of composition in
torch, for the tests.

The backward is the same scan run backwards in time (pallas_scan.py:
180-194): r[t] = g[t] + conj(p[t+1]) r[t+1], so x_bar = r and
p_bar = r conj(y[t-1]).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .state import use_twins

DTYPES = (torch.float32, torch.complex64)
TILE = 1024
"""Samples of a row that one block of the kernel scans (its ``kTile``)."""

launches = 0
"""Number of kernel launches so far, one per scan (the twin does not
count)."""

_workspaces: dict = {}
"""(device index, stream handle) -> (zeroed workspace, its tiles, its
address): the kernel's ticket counter, epoch and per-tile slots.  One per
stream, so scans that share one run in stream order; the kernel leaves it
ready for the next call, so it is zeroed only when it is made.  A scan
captured in a CUDA graph keeps its capture stream's workspace, so two
graphs that hold scans captured on one stream must not replay at once."""

_retired: list = []
"""Workspaces that a larger one replaced, kept alive: a CUDA graph
captured before may still hold their addresses."""


def first_order_scan_plain(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: Hillis-Steele over the last axis,
    element t absorbing element t-k for k = 1, 2, 4, ...  p and x share
    one shape."""
    T = x.shape[-1]
    k = 1
    while k < T:
        pk = torch.cat([torch.ones_like(p[..., :k]), p[..., :-k]], dim=-1)
        xk = torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)
        x = xk * p + x
        p = pk * p
        k *= 2
    return x


def first_order_scan_tiled(p: torch.Tensor, x: torch.Tensor,
                           per_thread: int = 4, lanes: int = 32,
                           warps: int = 8, chunk: int = 32) -> torch.Tensor:
    """The kernel's order of composition in torch, at any tile geometry (a
    model, used by nothing on the main path; the kernel's is the
    default).  Rows are cut into tiles of per_thread x lanes x warps
    samples, and the tiles into groups of ``chunk``.  In a tile: each
    thread composes its samples in order, each warp its threads' maps
    (Hillis-Steele over the lanes), and the warps' maps are composed in
    order into the tile's aggregate.  A set of up to ``chunk`` maps is
    composed by the fixed tree (lane l with lane l + d, d = 1, 2, 4, ...,
    identities past the set): a whole group's aggregate is the tree of its
    tiles'; the state entering a tile composes the trees of every earlier
    group's aggregate, ``chunk`` at a time and the chunks in order, then
    the tree of the earlier tiles of its own group.  Each thread then
    applies that state and the maps before it, and runs its samples.  p
    and x share one shape."""
    shape = x.shape
    T = shape[-1]
    R = x.numel() // T
    tile = per_thread * lanes * warps
    n_tiles = -(-T // tile)
    pad = n_tiles * tile - T
    grid = (R, n_tiles, warps, lanes, per_thread)
    p2 = torch.cat([p.reshape(R, T), torch.ones_like(p.reshape(R, T)[:, :1])
                    .expand(R, pad)], -1).reshape(grid)
    x2 = torch.cat([x.reshape(R, T), torch.zeros_like(x.reshape(R, T)[:, :1])
                    .expand(R, pad)], -1).reshape(grid)

    def compose(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    def identity(like):
        return torch.ones_like(like), torch.zeros_like(like)

    def lane_shift(t, d, fill):
        return torch.cat([torch.full_like(t[..., :d], fill), t[..., :-d]], -1)

    m = p2[..., 0], x2[..., 0]                  # (R, n_tiles, warps, lanes)
    for k in range(1, per_thread):
        m = compose(m, (p2[..., k], x2[..., k]))
    d = 1
    while d < lanes:
        o = lane_shift(m[0], d, 1.0), lane_shift(m[1], d, 0.0)
        upd = compose(o, m)
        keep = torch.arange(lanes, device=x.device) >= d
        m = tuple(torch.where(keep, u, v) for u, v in zip(upd, m))
        d *= 2
    before = lane_shift(m[0], 1, 1.0), lane_shift(m[1], 1, 0.0)
    wp, wx = m[0][..., -1], m[1][..., -1]       # (R, n_tiles, warps)
    agg = wp[..., 0], wx[..., 0]
    for w in range(1, warps):
        agg = compose(agg, (wp[..., w], wx[..., w]))
    aggs = [(agg[0][:, t], agg[1][:, t]) for t in range(n_tiles)]

    def tree(maps):
        g = maps + [identity(agg[0][:, 0])] * (chunk - len(maps))
        d = 1
        while d < chunk:
            for l in range(0, chunk, 2 * d):
                g[l] = compose(g[l], g[l + d])
            d *= 2
        return g[0]

    groups = [tree(aggs[g * chunk:(g + 1) * chunk])
              for g in range(n_tiles // chunk)]
    s_in = torch.zeros_like(wx[..., 0])         # (R, n_tiles)
    for t in range(1, n_tiles):
        group, member = divmod(t, chunk)
        prefix = tree(aggs[t - member:t])
        if group:
            earlier = None
            for c in range(0, group, chunk):
                g = tree(groups[c:min(c + chunk, group)])
                earlier = g if earlier is None else compose(earlier, g)
            prefix = compose(earlier, prefix)
        s_in[:, t] = prefix[1]

    pre = [identity(wp[..., 0])]
    for w in range(1, warps):
        pre.append(compose(pre[-1], (wp[..., w - 1], wx[..., w - 1])))
    pre = (torch.stack([q[0] for q in pre], -1)[..., None],
           torch.stack([q[1] for q in pre], -1)[..., None])
    pre = compose(pre, before)
    s = s_in[..., None, None] * pre[0] + pre[1]
    ys = []
    for k in range(per_thread):
        s = s * p2[..., k] + x2[..., k]
        ys.append(s)
    y = torch.stack(ys, -1).reshape(R, n_tiles * tile)[:, :T]
    return y.reshape(shape)


@functools.cache
def _lib():
    lib = build.library("scan")
    entries = {}
    for dtype, name in ((torch.float32, "first_order_scan_f32"),
                        (torch.complex64, "first_order_scan_c64")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[dtype] = fn
    nbytes = lib.first_order_scan_workspace_bytes
    nbytes.argtypes = [ctypes.c_longlong]
    nbytes.restype = ctypes.c_longlong
    return entries, nbytes


def _workspace(device: torch.device, stream: int, tiles: int):
    """The workspace of (device, stream), made (zeroed) or grown to hold at
    least ``tiles`` tiles: (tensor, tiles, address)."""
    ws = _workspaces.get((device.index, stream))
    if ws is None or ws[1] < tiles:
        if ws is not None:
            _retired.append(ws[0])
        cap = max(tiles, 4096, 2 * ws[1] if ws else 0)
        t = torch.zeros(_lib()[1](cap), dtype=torch.uint8, device=device)
        ws = _workspaces[(device.index, stream)] = (t, cap, t.data_ptr())
    return ws


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: conjugation and negation resolved,
    contiguous (itself where it already is)."""
    if t.is_conj() or t.is_neg():
        t = t.resolve_conj().resolve_neg()
    return t.contiguous()


def first_order_scan(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[t] = p[t] y[t-1] + x[t] over the last axis; p and x share one
    shape, device and dtype.

    A CPU tensor takes the plain twin.  A CUDA tensor launches the kernel,
    which takes float32 and complex64, and raises on anything else.
    """
    global launches
    if p.shape != x.shape:
        raise ValueError(
            f"p and x must share one shape, got {tuple(p.shape)} and "
            f"{tuple(x.shape)}")
    if p.device != x.device or p.dtype != x.dtype:
        raise ValueError("p and x must share device and dtype.")
    if not x.is_cuda or use_twins():
        return first_order_scan_plain(p, x)
    if x.dtype not in DTYPES:
        raise TypeError(
            f"the scan kernel takes float32 or complex64, not {x.dtype}")
    p = _dense(p)
    x = _dense(x)
    y = torch.empty_like(x)
    T = x.shape[-1] if x.ndim else 1
    R = x.numel() // T if T else 0
    if R == 0:
        return y
    device = x.device
    stream = torch.cuda.current_stream(device).cuda_stream
    entries, _ = _lib()
    _, cap, ws = _workspace(device, stream, R * -(-T // TILE))
    build.launch(entries[x.dtype], "first_order_scan", device, p.data_ptr(),
                 x.data_ptr(), y.data_ptr(), ws, cap, R, T, stream)
    launches += 1
    return y


class FirstOrderScan(torch.autograd.Function):
    """Differentiable scan on the kernel (its twin on the CPU)."""

    @staticmethod
    def forward(ctx, p, x):
        y = first_order_scan(p, x)
        ctx.save_for_backward(p, y)
        return y

    @staticmethod
    def backward(ctx, g):
        p, y = ctx.saved_tensors
        pc = p.conj()
        p_shift = torch.cat([pc[..., 1:], torch.zeros_like(pc[..., :1])],
                            dim=-1)
        r = torch.flip(first_order_scan(torch.flip(p_shift, (-1,)),
                                        torch.flip(g, (-1,))), (-1,))
        y_prev = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]],
                           dim=-1)
        return r * y_prev.conj(), r


def scan_diff(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable scan; p already broadcast to x's shape."""
    return FirstOrderScan.apply(p, x)
