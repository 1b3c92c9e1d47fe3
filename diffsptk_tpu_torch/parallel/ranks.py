"""One process a rank: :func:`spawn_ranks` starts the ranks of a mesh,
joins them in one process group and returns rank 0's result.

On the card each rank takes one card and NCCL; on the CPU the ranks are
gloo processes that share the host's cores.  The group's store is a
``FileStore`` in a temporary directory, so nothing listens on a port.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time

import torch

# seconds the ranks may take together, and a collective may wait
RANK_DEADLINE = 600.0


def _rank(worker, rank: int, world: int, device: str, store: str, out,
          args) -> None:
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        # one share of the cores a rank: threads that outnumber the cores
        # spin in each other's way
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_DEADLINE))
    try:
        result = worker(rank, world, device, *args)
        if rank == 0:
            out.put(result)
    finally:
        dist.destroy_process_group()


def spawn_ranks(worker, ranks: int, device: str, *args):
    """Run ``worker(rank, ranks, device, *args)`` in ``ranks`` new
    processes joined in one process group: NCCL with one card a rank where
    ``device`` is "cuda", gloo on the CPU otherwise.  ``worker`` is a
    module-level function, and ``args`` pickle.

    Returns what rank 0's call returns.  It waits no longer than
    ``RANK_DEADLINE`` seconds, nor for ranks that died, stops every rank
    before it returns, and raises ``RuntimeError`` unless every rank
    exited cleanly and rank 0 gave a result."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(worker, rank, ranks, device,
                                                 store, out, args))
                 for rank in range(ranks)]
        for proc in procs:
            proc.start()
        result, until = [], time.time() + RANK_DEADLINE
        try:
            # rank 0's result before joining, but no wait for dead ranks
            while not result and time.time() < until and not any(
                    proc.exitcode not in (None, 0) for proc in procs):
                try:
                    result.append(out.get(timeout=1.0))
                except queue.Empty:
                    pass
        finally:
            for proc in procs:
                proc.join(timeout=60 if result else 5)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    codes = [proc.exitcode for proc in procs]
    if any(codes) or not result:
        raise RuntimeError(f"{worker.__name__}: the ranks exited with "
                           f"{codes}" + ("" if result
                                         else ", no result from rank 0"))
    return result[0]
