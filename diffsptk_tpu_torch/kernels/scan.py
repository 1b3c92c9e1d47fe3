"""First-order affine scan: hand-written CUDA kernel, plain twin and autograd
Function (counterpart of ``diffsptk_tpu/kernels/pallas_scan.py``).

y[t] = p[t] y[t-1] + x[t] (y[-1] = 0) over the last axis, real or complex.
On a CUDA float32 / complex64 tensor the scan is ``csrc/scan.cu``; on a CPU
tensor it is :func:`first_order_scan_plain`, a log-depth Hillis-Steele
scan over T in torch (the counterpart of JAX's associative scan).

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

launches = 0
"""Number of kernel calls so far, one per scan (each enqueues up to three
grid passes; the twin does not count)."""


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


@functools.cache
def _lib(complex_: bool):
    lib = build.library("scan")
    fn = lib.first_order_scan_c64 if complex_ else lib.first_order_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = lib.first_order_scan_scratch
    scratch.argtypes = [ctypes.c_longlong] * 2
    scratch.restype = ctypes.c_longlong
    return fn, scratch


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
    p = p.resolve_conj().resolve_neg().contiguous()
    x = x.resolve_conj().resolve_neg().contiguous()
    y = torch.empty_like(x)
    T = x.shape[-1] if x.ndim else 1
    R = x.numel() // T if T else 0
    fn, scratch_values = _lib(x.dtype == torch.complex64)
    scratch = torch.empty(scratch_values(R, T), dtype=x.dtype,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(p.data_ptr(), x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                 R, T, stream)
    build.check(err, "first_order_scan")
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
