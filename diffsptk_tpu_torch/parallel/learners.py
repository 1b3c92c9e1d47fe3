"""Data-parallel learners (counterpart of
``diffsptk_tpu/parallel/learners.py``).

The GMM's E-steps reduce sufficient statistics over the data (the
responsibilities, the moments, the log-likelihood); with the data rows
spread over the ranks of a mesh axis, each rank sums its own rows and the
sums are all-reduced, as GSPMD compiles the JAX package's reductions to a
``psum``.  The LBG warm start's sums take the same reduction.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.learners import GaussianMixtureModeling
from .mesh import Axis, all_gather, all_reduce


class MeshRows:
    """The EM and Lloyd loops' reductions (``ops.learners.LocalRows``)
    with the rows spread over a mesh axis, as many on every rank: the
    statistics are all-reduced over the axis, and ``rows`` all-gathers
    each rank's row count on the device, which the next host read brings
    back and checks (the "divisible" ValueError, on every rank)."""

    def __init__(self, mesh: DeviceMesh, name: str) -> None:
        self.axis = Axis(mesh, name)
        self.name = name
        self.counts = None

    def rows(self, chunks) -> int:
        n = sum(c.shape[0] for c in chunks)
        self.counts = all_gather(torch.full(
            (1,), n, dtype=torch.float64, device=chunks[0].device),
            self.axis)
        return n * self.axis.size

    def sum(self, *stats) -> tuple:
        return tuple(all_reduce(s.clone(), self.axis) for s in stats)

    def read(self, *scalars) -> list:
        values = torch.stack(scalars).to(torch.float64)
        if self.counts is None:
            return values.tolist()
        values = torch.cat([values, self.counts.flatten()]).tolist()
        counts, self.counts = values[len(scalars):], None
        if min(counts) != max(counts):
            raise ValueError(
                f"data rows ({int(sum(counts))}) must be divisible by the "
                f"{self.name} axis size ({self.axis.size}), each rank "
                f"holding as many.")
        return values[:len(scalars)]


class DataParallelGMM(GaussianMixtureModeling):
    """GMM EM with the data rows spread over a mesh axis.

    Each rank passes its own rows, as many on every rank, and holds the
    full parameters, which stay equal on every rank: each EM step
    all-reduces the statistics over ``batch_axis_name`` (``MeshRows``),
    so the fit equals the one-rank fit on all the rows up to the order of
    sums.  Host steps are the one-rank GMM's: one read a step (the
    log-likelihood, and at the first step with it the ranks' row counts,
    so that unequal blocks raise the "divisible" ValueError on every
    rank).
    """

    def __init__(self, mesh: DeviceMesh, *args,
                 batch_axis_name: str = "dp", **kwargs) -> None:
        super().__init__(*args, reducer=MeshRows(mesh, batch_axis_name),
                         **kwargs)
        self.mesh = mesh
        self.batch_axis_name = batch_axis_name
