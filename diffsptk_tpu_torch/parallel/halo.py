"""Overlap-save halo exchange over a sharded time axis (counterpart of
``diffsptk_tpu/parallel/halo.py``).

Each time block receives the trailing samples of its left neighbour and
the leading samples of its right neighbour (one ``batch_isend_irecv`` of
both directions inside the axis' group), so unfold-style ops run
block-locally afterwards.  The ranks at the global edges pad as the
unsharded op pads its signal.
"""

from __future__ import annotations

import torch

from .mesh import Axis, neighbour_swap


def _edge_fill(x: torch.Tensor, width: int, dim: int, side: str,
               mode: str) -> torch.Tensor:
    n = x.shape[dim]
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = width
        return x.new_zeros(shape)
    if mode == "edge":
        # replicate the outermost local element at the global edge
        edge = x.narrow(dim, 0 if side == "left" else n - 1, 1)
        shape = list(x.shape)
        shape[dim] = width
        return edge.expand(shape)
    if mode == "reflect":
        # mirror about the global edge, excluding the edge sample (as
        # F.pad's mode="reflect")
        start = 1 if side == "left" else n - width - 1
        return torch.flip(x.narrow(dim, start, width), (dim,))
    raise ValueError(f"pad_mode {mode} is not supported.")


class _Halo(torch.autograd.Function):
    """The exchange and its transpose.  Every rank of the axis runs the
    backward whenever it runs the forward (the extended block is the whole
    output), so the backward's exchange is matched on both sides."""

    @staticmethod
    def forward(ctx, x, left, right, axis, dim, modes):
        ctx.geometry = (left, right, axis, dim, modes)
        n = x.shape[dim]
        from_left = from_right = None
        if axis.size > 1:
            from_left, from_right = neighbour_swap(
                x.narrow(dim, n - left, left) if left > 0 else None,
                x.narrow(dim, 0, right) if right > 0 else None, axis)
        parts = []
        if left > 0:
            parts.append(_edge_fill(x, left, dim, "left", modes[0])
                         if axis.first else from_left)
        parts.append(x)
        if right > 0:
            parts.append(_edge_fill(x, right, dim, "right", modes[1])
                         if axis.last else from_right)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        left, right, axis, dim, modes = ctx.geometry
        n = g.shape[dim] - left - right
        g_left = g.narrow(dim, 0, left) if left > 0 else None
        g_right = g.narrow(dim, left + n, right) if right > 0 else None
        gx = g.narrow(dim, left, n).clone()
        # each received halo's gradient goes back to its sender (an edge
        # rank sends nothing past the edge); this rank receives the
        # gradients of the slices it sent
        if axis.size > 1:
            g_head, g_tail = neighbour_swap(g_right, g_left, axis)
            if left > 0:
                gx.narrow(dim, n - left, left).add_(g_tail)
            if right > 0:
                gx.narrow(dim, 0, right).add_(g_head)
        # an edge fill's gradient goes to the local samples it copied
        for side, width, g_fill, edge in (("left", left, g_left, axis.first),
                                          ("right", right, g_right,
                                           axis.last)):
            mode = modes[0] if side == "left" else modes[1]
            if width == 0 or not edge or mode == "constant":
                continue
            if mode == "edge":
                at = 0 if side == "left" else n - 1
                gx.narrow(dim, at, 1).add_(g_fill.sum(dim, keepdim=True))
            else:                                       # reflect
                start = 1 if side == "left" else n - width - 1
                gx.narrow(dim, start, width).add_(torch.flip(g_fill, (dim,)))
        return gx, None, None, None, None, None


def exchange_halo(x: torch.Tensor, left: int, right: int, axis_name: Axis,
                  axis: int = -1,
                  pad_mode: str | tuple[str, str] = "constant"
                  ) -> torch.Tensor:
    """Extend the local time block with its neighbours' halos.

    x: the local block, time on ``axis``; ``left``/``right`` are the halo
    widths in samples; ``axis_name`` is the time :class:`~.mesh.Axis`.
    The global-edge ranks pad with ``pad_mode`` ('constant' zeros,
    'edge', 'reflect'); a (left_mode, right_mode) pair sets the two
    global edges apart (PQMF's zero-left / replicate-right delay padding).

    A ``torch.autograd.Function``: the forward sends the tail right and
    the head left (one ``batch_isend_irecv``) and fills the global edges;
    the backward is its transpose -- each received halo's gradient goes
    back to its sender and is added onto the slice it came from, an edge
    fill's gradient goes to the local samples it copied (none for zeros).
    At size 1 nothing is sent and both edges are fills, of any width
    ('reflect' excepted, which mirrors the block).
    """
    modes = ((pad_mode, pad_mode) if isinstance(pad_mode, str)
             else tuple(pad_mode))
    for mode in modes:
        if mode not in ("constant", "edge", "reflect"):
            raise ValueError(f"pad_mode {mode} is not supported.")
    dim = axis % x.ndim
    n = x.shape[dim]
    # at size 1 there is no neighbour, and a halo wider than the block is
    # only the edge padding
    if axis_name.size > 1 and max(left, right) > n:
        raise ValueError(
            f"halo ({left}, {right}) exceeds the local block length {n}: "
            f"a rank reaches only its immediate neighbour -- enlarge the "
            f"per-rank block or reduce the halo.")
    return _Halo.apply(x, left, right, axis_name, dim, modes)
