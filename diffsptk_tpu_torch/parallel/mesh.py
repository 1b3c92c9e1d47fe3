"""Device meshes and the collectives of the sharded paths (counterpart of
``diffsptk_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``(dp, tp)`` ``Mesh`` with
``jax.shard_map``.  The port runs the same local functions once per rank,
in PyTorch's own SPMD idiom: one process per device (``torchrun``), the
mesh a ``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are
named as the JAX package names its axes (``dp``: batch or channels, ``tp``:
time blocks).  Each named dimension resolves to its process group:

* ``lax.axis_index`` / ``lax.axis_size`` -- :class:`Axis` ``index`` and
  ``size`` (``mesh.get_local_rank(name)``, the mesh's shape);
* ``lax.ppermute`` to a neighbour -- :func:`swap` (``batch_isend_irecv``
  of ``P2POp``s inside the axis' group, every rank posting its sends and
  receives at once; at size 1 nothing is sent);
* ``lax.all_gather`` -- :func:`all_gather`, which passes the gradient;
* GSPMD's ``psum`` -- ``dist.all_reduce`` in the axis' group
  (:func:`all_reduce`; over every axis, :func:`mesh_sum`);
* the transpose of a parameter closed over with ``P()`` (summed over
  every axis) -- :func:`reduce_replicated_grads`, once after
  ``backward``.

A sharded class takes the rank's local block and returns its local block;
:func:`shard` cuts a global tensor into this rank's block and
:func:`unshard` gathers the blocks back, for callers that hold the whole
array (and for the tests).
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import resolve_device


def make_mesh(shape: tuple[int, ...] | int | None = None,
              axis_names: tuple[str, ...] = ("dp", "tp"),
              device_type: str | None = None) -> DeviceMesh:
    """A mesh over the ranks of the initialised default process group.

    ``shape=None`` puts all ranks on one axis per name (the last axis gets
    the remainder); an int means a 1-D mesh of that size on the last name.
    The mesh takes ranks 0 .. prod(shape) - 1; a rank outside it has no
    coordinate in it (``get_coordinate()`` is None).  ``device_type=None``
    means the card, as every operator of the port, and raises where there
    is none; each CUDA rank takes its local device (``LOCAL_RANK``, as
    ``torchrun`` sets it, else the rank modulo the number of cards).
    Every rank of the default group calls this together.
    """
    device = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or torchrun)")
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) == 1:
            shape = (world,)
        else:
            dp = max(1, world // 2)
            shape = (dp, world // dp)
            axis_names = axis_names[:2]
    elif isinstance(shape, int):
        shape = (shape,)
        axis_names = axis_names[-1:]
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if device.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names[:len(shape)]))


def has_axis(mesh: DeviceMesh, name: str | None) -> bool:
    return name is not None and name in (mesh.mesh_dim_names or ())


def axis_size(mesh: DeviceMesh, name: str | None) -> int:
    """The number of ranks along ``name`` (1 for an axis the mesh lacks)."""
    if not has_axis(mesh, name):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


class Axis:
    """One named dimension of a mesh as this rank sees it: its process
    group, this rank's index along it and its size.  An axis the mesh
    lacks (``name=None``, or a name not in the mesh) is a trivial one of
    size 1."""

    def __init__(self, mesh: DeviceMesh, name: str | None) -> None:
        self.size = axis_size(mesh, name)
        if has_axis(mesh, name):
            self.group = mesh.get_group(name)
            self.index = int(mesh.get_local_rank(name))
        else:
            self.group, self.index = None, 0

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    @classmethod
    def of_group(cls, group) -> "Axis":
        """The axis whose ranks are those of a process group."""
        axis = cls.__new__(cls)
        axis.group = group
        axis.index = dist.get_rank(group)
        axis.size = dist.get_world_size(group)
        return axis

    def rank(self, i: int) -> int:
        """The global rank of index ``i`` along the axis."""
        return dist.get_global_rank(self.group, i)


def as_axis(axis) -> Axis:
    """An :class:`Axis` from an Axis, a process group, or a (mesh,
    dimension name) pair."""
    if isinstance(axis, Axis):
        return axis
    if isinstance(axis, tuple):
        return Axis(*axis)
    return Axis.of_group(axis)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _exchange(sends, recvs, axis: Axis) -> None:
    """Post every send and receive at once and wait for them: ``sends``
    and ``recvs`` are (contiguous tensor, index along the axis) pairs; a
    complex tensor travels as its real view."""
    ops = [dist.P2POp(dist.isend, _real(t), axis.rank(i), group=axis.group)
           for t, i in sends]
    ops += [dist.P2POp(dist.irecv, _real(t), axis.rank(i), group=axis.group)
            for t, i in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def neighbour_swap(to_right: torch.Tensor | None,
                   to_left: torch.Tensor | None, axis: Axis):
    """One neighbour exchange along the axis, without a ring: send
    ``to_right`` to index + 1 and ``to_left`` to index - 1; return what
    came from the left and from the right (zeros where there is no
    neighbour, and None for a direction not asked for).  Both sides of a
    pair must ask for the same directions."""
    def buffer(t):
        return None if t is None else torch.zeros(t.shape, dtype=t.dtype,
                                                  device=t.device)

    from_left, from_right = buffer(to_right), buffer(to_left)
    sends, recvs = [], []
    if to_right is not None:
        if not axis.last:
            sends.append((to_right.contiguous(), axis.index + 1))
        if not axis.first:
            recvs.append((from_left, axis.index - 1))
    if to_left is not None:
        if not axis.first:
            sends.append((to_left.contiguous(), axis.index - 1))
        if not axis.last:
            recvs.append((from_right, axis.index + 1))
    _exchange(sends, recvs, axis)
    return from_left, from_right


class _Swap(torch.autograd.Function):
    """:func:`neighbour_swap` with its transpose as the backward: the
    gradient of what came from the left goes back to the left neighbour,
    and is the gradient of what this rank sent it."""

    @staticmethod
    def forward(ctx, to_right, to_left, axis):
        ctx.axis = axis
        return neighbour_swap(to_right, to_left, axis)

    @staticmethod
    def backward(ctx, g_from_left, g_from_right):
        # the left neighbour's gradient of what came to it from the right
        # is the gradient of what this rank sent left, and so on
        g_to_left, g_to_right = neighbour_swap(g_from_right, g_from_left,
                                               ctx.axis)
        return g_to_right, g_to_left, None


def swap(to_right: torch.Tensor, to_left: torch.Tensor, axis: Axis):
    """Differentiable :func:`neighbour_swap` of two tensors."""
    return _Swap.apply(to_right, to_left, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(out, x, group=axis.group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g[ctx.axis.index], None


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.all_gather``: (size, *x.shape), index i holding rank i's x.
    The backward sums the gradients of every rank and keeps this rank's
    slice (an all-reduce: gloo has no reduce-scatter).  At size 1 it is
    ``x[None]``."""
    if axis.size == 1:
        return x[None]
    return _AllGather.apply(x, axis)


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis (in place; returned)."""
    if axis.size > 1:
        dist.all_reduce(x, group=axis.group)
    return x


def mesh_sum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of the mesh (in place; returned):
    one all-reduce along each named dimension in turn.  Every rank ends
    with the same bits, since each step sums the same values in the same
    order on all of them.  Not differentiable."""
    for name in mesh.mesh_dim_names or ():
        all_reduce(x, Axis(mesh, name))
    return x


def reduce_replicated_grads(params, mesh: DeviceMesh) -> None:
    """Sum ``.grad`` of each replicated parameter over every rank of the
    mesh (both ``dp`` and ``tp``), in place, once, after ``backward``.

    The transpose of a parameter that the JAX package closes over inside
    ``shard_map`` (an input with ``P()``): each rank's backward gives the
    gradient of its own share of the loss, and the parameter's gradient is
    their sum.  It stays outside autograd: a differentiable sum whose
    backward is again an all-reduce would count the replicated loss once
    a rank.  Sharded parameters keep their local gradients (a halo's share
    already comes back through ``exchange_halo``'s backward).  The
    gradients travel as one flat buffer; a parameter without one is
    skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = mesh_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _split(x: torch.Tensor, dim: int, axis: Axis, tail: int = 0):
    n = x.shape[dim] - tail
    if n % axis.size:
        raise ValueError(
            f"dimension {dim} of length {n} does not divide into "
            f"{axis.size} blocks")
    b = n // axis.size
    length = b + (tail if axis.last else 0)
    return x.narrow(dim, axis.index * b, length)


def shard(x: torch.Tensor, mesh: DeviceMesh, time_dim: int | None = -1,
          batch_dim: int | None = 0, *, time_axis_name: str = "tp",
          batch_axis_name: str | None = "dp", tail: int = 0
          ) -> torch.Tensor:
    """This rank's block of a global tensor: ``batch_dim`` cut evenly over
    the batch axis (when the mesh has it), ``time_dim`` cut evenly over the
    time axis after setting aside its last ``tail`` entries, which go to
    the last time rank (``ShardedMDCT``'s trailing frame).  ``None`` leaves
    a dimension whole.  A view of ``x``."""
    if batch_dim is not None:
        x = _split(x, batch_dim, Axis(mesh, batch_axis_name))
    if time_dim is not None:
        x = _split(x, time_dim, Axis(mesh, time_axis_name), tail)
    return x


def _gather_cat(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """Blocks of any length along ``dim`` from every rank of the axis,
    joined in rank order (a host read of the lengths)."""
    if axis.size == 1:
        return x
    dim = dim % x.ndim
    n = torch.tensor([x.shape[dim]], device=x.device)
    sizes = [torch.empty_like(n) for _ in range(axis.size)]
    dist.all_gather(sizes, n, group=axis.group)
    sizes = [int(s) for s in torch.cat(sizes).tolist()]
    top = max(sizes)
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, top - x.shape[dim]]
    xp = torch.nn.functional.pad(x, pad).contiguous()
    parts = [torch.empty_like(xp) for _ in range(axis.size)]
    dist.all_gather(parts, xp, group=axis.group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


def unshard(y: torch.Tensor, mesh: DeviceMesh, time_dim: int | None = -1,
            batch_dim: int | None = 0, *, time_axis_name: str = "tp",
            batch_axis_name: str | None = "dp") -> torch.Tensor:
    """The global tensor from every rank's local block (the inverse of
    :func:`shard`): blocks joined along ``time_dim`` over the time axis,
    whatever their lengths, then along ``batch_dim`` over the batch axis.
    Every rank of the mesh calls it and receives the whole tensor."""
    if time_dim is not None:
        y = _gather_cat(y, time_dim, Axis(mesh, time_axis_name))
    if batch_dim is not None:
        y = _gather_cat(y, batch_dim, Axis(mesh, batch_axis_name))
    return y
