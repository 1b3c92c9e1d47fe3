"""The arithmetic the plain reference runs in, and the numbers that
decide ``correct``.

The reference runs in float64 (``Arith("float64")``).  Its control runs
the same code in the nearest precision below the configuration's float32
with TF32 off: float32 whose products round both operands to TF32 (10
explicit mantissa bits) before the product, as the card's tensor cores do
once ``allow_tf32`` is on (``Arith("tf32")``).  The rounding is explicit
so that the control does not depend on which kernel the library picks.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32, to nearest with ties away from
    zero, kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class Arith:
    """A precision for the reference: its dtype and its matmul."""

    def __init__(self, name: str) -> None:
        if name not in ("float64", "tf32"):
            raise ValueError(f"no arithmetic named {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def _operands(self, *ts):
        return tuple(round_tf32(t) for t in ts) if self.name == "tf32" \
            else ts

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(*self._operands(a, b))

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        return F.conv1d(*self._operands(x, w), **kw)

    def conv_transpose1d(self, x: torch.Tensor, w: torch.Tensor,
                         **kw) -> torch.Tensor:
        return F.conv_transpose1d(*self._operands(x, w), **kw)

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for the control's library calls, off for float64."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def gap_parts(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |out - ref|, max |ref|), in float64 (complex128 for complex
    outputs); an infinite gap where the shapes differ or ``out`` holds a
    non-finite value."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf"), 1.0
    wide = torch.complex128 if out.is_complex() else torch.float64
    out = out.to(wide)
    ref = ref.to(device=out.device, dtype=wide)
    if not bool(torch.isfinite(out).all()):
        return float("inf"), 1.0
    return float((out - ref).abs().max()), float(ref.abs().max())


def widest_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over max |ref| (``gap_parts``)."""
    err, scale = gap_parts(out, ref)
    return err / scale


def faults(outs: dict, x: torch.Tensor | None = None) -> dict:
    """The faults a cell's check has to catch, each planted on the
    program's outputs ``outs`` (the batch on each output's first axis):
    half of the batch left out (its rows zero); one answer altered where
    it is produced (each output's first value, its first row's first
    step, moved by 1e-2 of its largest); and, where ``x`` is the call's
    input and an output ``y`` its synthesis, the synthesis skipped (the
    input handed back)."""
    half = {k: v.clone() for k, v in outs.items()}
    for v in half.values():
        v[v.shape[0] // 2:] = 0
    moved = {k: v.clone() for k, v in outs.items()}
    for v in moved.values():
        v.view(-1)[0] += 1e-2 * float(v.abs().max())
    found = {"half_batch": half, "one_value": moved}
    if x is not None and "y" in outs:
        found["synthesis_skipped"] = dict(
            outs, y=x[..., :outs["y"].shape[-1]].to(outs["y"].dtype))
    return found


def readings(checks: dict, outs: dict, want: dict, control: dict,
             x: torch.Tensor | None = None) -> dict:
    """``gap_parts`` of each number of ``checks`` (name: output) for the
    program's outputs, the control's and each fault's (``faults``),
    against the reference's ``want``: {side: {name: (err, scale)}}."""
    sides = {"program": outs, "control": control, **faults(outs, x)}
    return {side: {name: gap_parts(o[key], want[key])
                   for name, key in checks.items()}
            for side, o in sides.items()}


def pooled(parts: list) -> dict:
    """Each number's gap over several comparisons (a list of
    {name: (err, scale)}): the largest err over the largest scale."""
    return {name: max(p[name][0] for p in parts)
            / max(p[name][1] for p in parts) for name in parts[0]}
