"""Residual of one Newton step of mel-cepstral analysis: hand-written CUDA
kernel, plain twin and autograd Function.

Between two Newton solves, mel-cepstral analysis (``ops/mcep.py``, also
``ops/smcep.py`` with its own matrices) forms, for every frame b,

    D[k]  = sum_m P1[m, k] mc[m, b]
    d[k]  = exp(log_x[b, k] - 2 D[k])
    rt[j] = sum_k P2[k, j] d[k]
    ra[j] = rt[j] - av[j]                 (j < n)

from mc_t (n, B) lane-major and log_x (B, H+1) row-major, and returns rt_t
(2n-1, B) and ra_t (n, B) lane-major: the generator and right-hand side
that :func:`kernels.newton.newton_solve_t` takes.  On a CUDA float32
tensor this is ``csrc/mcep_residual.cu``, one kernel that keeps D and d
on the chip; on a CPU tensor, or inside ``twins()``, it is
:func:`mcep_residual_plain`, the two matmuls and the exp in torch.

The backward recomputes D and d in torch: with g the gradient of rt_t
plus that of ra_t on its first n rows, g_d = P2 g, g_lx = d * g_d,
g_mc = -2 P1 g_lx, g_P1 = -2 mc g_lx, g_P2 = d g and g_av = -sum_b g_ra.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import span
from . import build
from .state import use_twins

MAX_ORDER = 33

launches = 0
"""Number of kernel launches so far (the twin does not count)."""


def mcep_residual_plain(mc_t: torch.Tensor, log_x: torch.Tensor,
                        P1: torch.Tensor, P2: torch.Tensor,
                        av: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin: the lane-major composition of two matmuls, the
    exp and the subtraction."""
    n = mc_t.shape[0]
    D = torch.matmul(P1.T, mc_t)                        # (H+1, B)
    d = torch.exp(log_x.T - D - D)
    rt_t = torch.matmul(P2.T, d)                        # (2n-1, B)
    return rt_t, rt_t[:n] - av[:, None]


def _check(mc_t, log_x, P1, P2, av) -> tuple[int, int, int]:
    """The shapes: mc_t (n, B), log_x (B, F), P1 (n, F), P2 (F, 2n-1),
    av (n), all on one device in one dtype.  Returns (n, B, F)."""
    if mc_t.ndim != 2 or log_x.ndim != 2:
        raise ValueError("mc_t must be (n, B) and log_x (B, F).")
    n, B = mc_t.shape
    F = log_x.shape[1]
    if log_x.shape[0] != B:
        raise ValueError(
            f"log_x must have B = {B} rows, got {tuple(log_x.shape)}.")
    for name, t, shape in (("P1", P1, (n, F)), ("P2", P2, (F, 2 * n - 1)),
                           ("av", av, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}.")
    if any(t.device != mc_t.device or t.dtype != mc_t.dtype
           for t in (log_x, P1, P2, av)):
        raise ValueError("mc_t, log_x, P1, P2 and av must share device and "
                         "dtype.")
    return n, B, F


@functools.cache
def _lib():
    lib = build.library("mcep_residual")
    fn = lib.mcep_residual_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@span("kernel.mcep_residual")
def _launch(mc_t, log_x, P1, P2, av, n: int, B: int, F: int):
    global launches
    if mc_t.dtype != torch.float32:
        raise TypeError(
            f"the mcep residual kernel takes float32, not {mc_t.dtype}")
    if n > MAX_ORDER:
        raise ValueError(
            f"the mcep residual kernel takes n <= {MAX_ORDER}, not {n}")
    if not all(t.is_contiguous() for t in (mc_t, log_x, P1, P2, av)):
        raise ValueError("the mcep residual kernel takes contiguous tensors")
    rt_t = torch.empty((2 * n - 1, B), dtype=mc_t.dtype, device=mc_t.device)
    ra_t = torch.empty((n, B), dtype=mc_t.dtype, device=mc_t.device)
    if B == 0:                     # nothing to launch
        return rt_t, ra_t
    stream = torch.cuda.current_stream(mc_t.device).cuda_stream
    build.launch(_lib(), "mcep_residual_f32", mc_t.device, mc_t.data_ptr(),
                 log_x.data_ptr(), P1.data_ptr(), P2.data_ptr(),
                 av.data_ptr(), rt_t.data_ptr(), ra_t.data_ptr(), n, B, F,
                 stream)
    launches += 1
    return rt_t, ra_t


def mcep_residual_lane_major(mc_t: torch.Tensor, log_x: torch.Tensor,
                             P1: torch.Tensor, P2: torch.Tensor,
                             av: torch.Tensor):
    """rt_t (2n-1, B) and ra_t (n, B) of every frame.

    A CPU tensor takes the plain twin.  A CUDA tensor launches the kernel,
    which takes contiguous float32 with n <= 33, and raises on anything
    else.
    """
    n, B, F = _check(mc_t, log_x, P1, P2, av)
    if not mc_t.is_cuda or use_twins():
        return mcep_residual_plain(mc_t, log_x, P1, P2, av)
    return _launch(mc_t, log_x, P1, P2, av, n, B, F)


class McepResidualT(torch.autograd.Function):
    """Differentiable residual; the backward recomputes D and d."""

    @staticmethod
    def forward(ctx, mc_t, log_x, P1, P2, av):
        rt_t, ra_t = mcep_residual_lane_major(mc_t, log_x, P1, P2, av)
        ctx.save_for_backward(mc_t, log_x, P1, P2)
        return rt_t, ra_t

    @staticmethod
    def backward(ctx, g_rt, g_ra):
        mc_t, log_x, P1, P2 = ctx.saved_tensors
        n = mc_t.shape[0]
        need_mc, need_lx, need_p1, need_p2, need_av = ctx.needs_input_grad
        g = torch.cat([g_rt[:n] + g_ra, g_rt[n:]])       # (2n-1, B)
        g_mc = g_lx = g_p1 = g_p2 = g_av = None
        if need_mc or need_lx or need_p1 or need_p2:
            D = torch.matmul(mc_t.T, P1)                 # (B, F)
            d = torch.exp(log_x - D - D)
            if need_p2:
                g_p2 = torch.matmul(d.T, g.T)
            if need_mc or need_lx or need_p1:
                g_lx = d * torch.matmul(g.T, P2.T)
                if need_mc:
                    g_mc = -2 * torch.matmul(P1, g_lx.T)
                if need_p1:
                    g_p1 = -2 * torch.matmul(mc_t, g_lx)
                if not need_lx:
                    g_lx = None
        if need_av:
            g_av = -g_ra.sum(dim=1)
        return g_mc, g_lx, g_p1, g_p2, g_av


def mcep_residual(mc_t: torch.Tensor, log_x: torch.Tensor, P1: torch.Tensor,
                  P2: torch.Tensor, av: torch.Tensor):
    """mc_t (n, B), log_x (B, H+1), P1 (n, H+1), P2 (H+1, 2n-1), av (n) ->
    rt_t (2n-1, B), ra_t (n, B), differentiable in every input."""
    return McepResidualT.apply(mc_t, log_x, P1, P2, av)
