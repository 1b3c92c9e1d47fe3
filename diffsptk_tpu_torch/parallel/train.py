"""The JAX package's multi-chip training step on the port (counterpart of
``dryrun_multichip`` in the JAX repository's ``__graft_entry__.py``).

One SGD step through every sharded path over a (dp, tp) mesh, at the
flagship configuration (frame 400/80, fft 512, cep 24; WORLD at its
80/16000/1024 default):

* ``ShardedSTFT`` with a learnable window (replicated: its gradient is
  summed over every rank, :func:`~.mesh.reduce_replicated_grads`),
* ``ShardedMelCepstralVocoder.synthesize`` with the per-stage halo and,
  at Taylor order 6 and cepstral order 99, the bulk halo, both trained
  through the same mel-cepstra ``mc`` (sharded like the frames),
* ``ShardedWorldVocoder.analysis_synthesis`` (no parameter: it adds to
  the loss's value only),
* ``ShardedAllPoleDigitalFilter`` at M 24, P 80, trained through ``lpc``,
* ``ShardedMDCT``/``ShardedIMDCT`` (240) and ``ShardedPQMF``/
  ``ShardedIPQMF`` (4 bands, order 47) round trips.

Every rank passes its blocks and computes its share of each of the seven
global means (its local sum over the global count), so the ranks' shares
sum to the JAX package's loss and each rank's backward gives the
gradient of its share.  The step makes no host read.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from .filterbanks import ShardedIMDCT, ShardedIPQMF, ShardedMDCT, ShardedPQMF
from .filters import ShardedAllPoleDigitalFilter
from .mesh import mesh_sum, reduce_replicated_grads, shard
from .sharded import ShardedSTFT
from .vocoder import ShardedMelCepstralVocoder
from .world import ShardedWorldVocoder

FL, FP, FFT, M = 400, 80, 512, 24       # the flagship configuration
LR = 1e-3                               # the JAX step's SGD rate
TERMS = ("spec", "voc", "world", "apf", "bulk", "mdct", "pqmf")


def dryrun_shape(n: int) -> tuple[int, int, int, int]:
    """(dp, tp, B, T) of the JAX package's dryrun on n devices: the mesh
    by its rule dp = max(1, n // 2), and the global batch and length."""
    dp = max(1, n // 2)
    tp = n // dp
    return dp, tp, max(2, dp), 2400 * tp


def dryrun_inputs(B: int, T: int, dtype=np.float64, seed: int = 0) -> dict:
    """The step's global inputs as numpy, drawn as the JAX dryrun draws
    them from ``np.random.default_rng(seed)``: x (B, T) first, then the
    mel-cepstra (B, T/80, 25); the LPC coefficients [1, 0, ...] and a
    target spectrum of ones (B, T/80, 257).  In float32 x is cast before
    it is scaled, as the JAX dryrun scales it."""
    N = T // FP
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T)).astype(dtype) * np.asarray(1e-2, dtype)
    mc = (0.01 * rng.standard_normal((B, N, M + 1))).astype(dtype)
    lpc = np.concatenate([np.ones((B, N, 1)), np.zeros((B, N, M))],
                         -1).astype(dtype)
    target = np.ones((B, N, FFT // 2 + 1), dtype)
    return {"x": x, "mc": mc, "lpc": lpc, "target": target}


class DryrunStep:
    """The dryrun's nine sharded operators on ``mesh``, its loss and its
    SGD step.  Operators are built on ``device`` in ``dtype`` as every
    operator of the port (on the card unless ``device="cpu"``).

    Parameters are a dict ``{"window": {"window": w}, "mc": mc_block,
    "lpc": lpc_block}`` of leaf tensors that require grad
    (:meth:`params_from_jax`); the window whole on every rank, mc and lpc
    this rank's blocks."""

    def __init__(self, mesh: DeviceMesh, *, dtype=None, device=None) -> None:
        kw = dict(dtype=dtype, device=device)
        self.mesh = mesh
        self.sstft = ShardedSTFT(mesh, FL, FP, FFT, learnable=["window"],
                                 eps=1e-6, **kw)
        self.dtype = self.sstft.op.window.window.dtype
        self.device = self.sstft.op.window.window.device
        self.voc = ShardedMelCepstralVocoder(
            mesh, frame_length=FL, frame_period=FP, fft_length=FFT,
            cep_order=M, n_iter=10, **kw)
        self.world = ShardedWorldVocoder(mesh, FP, 16000, 1024, **kw)
        self.apf = ShardedAllPoleDigitalFilter(mesh, M, FP)
        # one exchange for the whole cascade: its 18-frame left halo must
        # fit the local block, so 6 stages of order 99
        self.voc_bulk = ShardedMelCepstralVocoder(
            mesh, frame_length=FL, frame_period=FP, fft_length=FFT,
            cep_order=M, n_iter=10, taylor_order=6, cep_order_mlsa=99, **kw)
        self.smdct = ShardedMDCT(mesh, 240, **kw)
        self.simdct = ShardedIMDCT(mesh, 240, **kw)
        self.spqmf = ShardedPQMF(mesh, 4, 47, **kw)
        self.sipqmf = ShardedIPQMF(mesh, 4, 47, **kw)

    # --------------------------------------------------------- parameters
    def window_init(self) -> np.ndarray:
        """The STFT's initial window (the JAX op's trainable parameter)."""
        return self.sstft.op.window.window.detach().cpu().numpy()

    def params_from_jax(self, params: dict) -> dict:
        """The port's parameters from the JAX step's params pytree as
        numpy, ``{"window": {"window": w}, "mc": mc, "lpc": lpc}`` with mc
        and lpc global (B, N, 25): the window whole, mc and lpc cut into
        this rank's blocks, each a leaf that requires grad."""
        def leaf(a, cut=False):
            t = torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                device=self.device)
            if cut:
                t = shard(t, self.mesh, time_dim=-2)
            return t.clone().requires_grad_(True)

        return {"window": {k: leaf(v) for k, v in params["window"].items()},
                "mc": leaf(params["mc"], True),
                "lpc": leaf(params["lpc"], True)}

    def blocks(self, inputs: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's blocks of the global x and target (numpy)."""
        def cut(a, time_dim):
            t = torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                device=self.device)
            return shard(t, self.mesh, time_dim=time_dim).contiguous()

        return cut(inputs["x"], -1), cut(inputs["target"], -2)

    # --------------------------------------------------------------- loss
    def _share(self, d: torch.Tensor) -> torch.Tensor:
        """This rank's share of the global mean of d ** 2: every rank's
        block of it has d's size."""
        return (d * d).sum() / (d.numel() * self.mesh.size())

    def term(self, name: str, p: dict, x: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
        """This rank's share of one of the loss's seven means
        (``TERMS``)."""
        if name == "spec":
            return self._share(self.sstft(x, window_params=p["window"])
                               - target)
        if name == "voc":
            return self._share(self.voc.synthesize(x, p["mc"]) - x)
        if name == "world":
            return self._share(self.world.analysis_synthesis(x))
        if name == "apf":
            return self._share(self.apf(x, p["lpc"]) - x)
        if name == "bulk":
            return self._share(self.voc_bulk.synthesize(x, p["mc"],
                                                        halo="bulk") - x)
        if name == "mdct":
            # the block is a multiple of the MDCT's period, so the JAX
            # step's out_length = T cuts nothing
            return self._share(self.simdct(self.smdct(x)) - x)
        if name == "pqmf":
            return self._share(self.sipqmf(self.spqmf(x))[..., 0, :] - x)
        raise ValueError(f"term {name} is not one of {TERMS}.")

    def loss(self, p: dict, x: torch.Tensor, target: torch.Tensor):
        """(this rank's share of the loss, {term: its share})."""
        terms = {name: self.term(name, p, x, target) for name in TERMS}
        return sum(terms.values()), terms

    def backward(self, p: dict, x: torch.Tensor, target: torch.Tensor):
        """(this rank's share of the loss, {term: its share}), detached:
        the share's backward into the parameters' ``.grad`` (cleared
        first).  The window's ``.grad`` is then this rank's own; the
        replicated gradient is its sum over every rank (:meth:`update`,
        :meth:`loss_and_grads`)."""
        for t in (*p["window"].values(), p["mc"], p["lpc"]):
            t.grad = None
        total, terms = self.loss(p, x, target)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in terms.items()}

    def loss_and_grads(self, p: dict, x: torch.Tensor,
                       target: torch.Tensor):
        """(this rank's share of the loss, its terms, the gradients): the
        backward of the share, then the window's gradient summed over every
        rank.  The gradients are the parameters' ``.grad``, in the
        parameters' layout."""
        total, terms = self.backward(p, x, target)
        reduce_replicated_grads(p["window"].values(), self.mesh)
        grads = {"window": {k: v.grad for k, v in p["window"].items()},
                 "mc": p["mc"].grad, "lpc": p["lpc"].grad}
        return total, terms, grads

    def update(self, p: dict) -> dict:
        """The new parameters after a :meth:`backward`: the window's
        gradient summed over every rank, then p - LR g under ``no_grad``,
        each a new leaf that requires grad."""
        reduce_replicated_grads(p["window"].values(), self.mesh)

        def sgd(a):
            return (a - LR * a.grad).requires_grad_(True)

        with torch.no_grad():
            return {"window": {k: sgd(v) for k, v in p["window"].items()},
                    "mc": sgd(p["mc"]), "lpc": sgd(p["lpc"])}

    def train_step(self, p: dict, x: torch.Tensor, target: torch.Tensor):
        """(the loss summed over every rank, the new parameters p - LR g):
        a tensor on the step's device, read by no one here."""
        total, _ = self.backward(p, x, target)
        return mesh_sum(total, self.mesh), self.update(p)
