"""Vector quantization (counterpart of ``diffsptk_tpu/ops/vq.py``).

Nearest-neighbour codebook lookup with a straight-through estimator and a
commitment loss, and its residual (multi-stage) form.  Codebooks are
``nn.Parameter``s drawn from JAX's generator on the op's device
(``kernels/threefry.py``), so a seed gives the JAX package's codebook
(bit for bit at float32, ROADMAP C.13).
"""

from __future__ import annotations

import torch

from ..core import BaseNonFunctionalOp, check_size, full_precision, \
    resolve_device
from ..kernels import threefry
from ..utils import prng
from ..utils.profiling import span


def _nearest(x: torch.Tensor, codebook: torch.Tensor):
    """x (..., D), codebook (K, D) -> (xq, indices): one distance GEMM and
    an argmin."""
    d = (torch.sum(x * x, dim=-1, keepdim=True)
         - 2 * x @ codebook.T
         + torch.sum(codebook * codebook, dim=-1))
    indices = torch.argmin(d, dim=-1)
    return codebook[indices], indices


def initial_codebook(seed, shape, dtype, device) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape, dtype)`` on ``device``;
    ``seed`` may also be a key on the host."""
    key = seed if isinstance(seed, torch.Tensor) else prng.PRNGKey(seed)
    return threefry.normal(key, shape, dtype, device)


class VectorQuantization(BaseNonFunctionalOp):
    """x (..., M+1) -> (xq, indices, commitment loss)."""

    def __init__(self, order: int, codebook_size: int, *, seed: int = 0,
                 beta: float = 0.25, dtype=None, device=None,
                 **kwargs) -> None:
        super().__init__()
        if order < 0:
            raise ValueError("order must be non-negative.")
        if codebook_size <= 0:
            raise ValueError("codebook_size must be positive.")
        self.order = order
        self.codebook_size = codebook_size
        self.beta = beta
        self.codebook = torch.nn.Parameter(initial_codebook(
            seed, (codebook_size, order + 1),
            dtype or torch.get_default_dtype(), resolve_device(device)))

    @full_precision
    @span("VectorQuantization")
    def forward(self, x: torch.Tensor, codebook=None):
        codebook = self.codebook if codebook is None else codebook
        check_size(x.shape[-1], self.order + 1, "dimension of input")
        xq, indices = _nearest(x, codebook)
        loss = torch.mean(torch.square(xq.detach() - x))
        xq = x + (xq - x).detach()          # straight-through
        return xq, indices, loss


class InverseVectorQuantization(BaseNonFunctionalOp):
    """Codebook lookup: indices -> xq.  The codebook arrives at call time,
    or from a bound :class:`VectorQuantization`."""

    def __init__(self, vq: VectorQuantization | None = None) -> None:
        super().__init__()
        self.vq = vq

    @span("InverseVectorQuantization")
    def forward(self, indices: torch.Tensor, codebook=None) -> torch.Tensor:
        if codebook is None:
            if self.vq is None:
                raise ValueError(
                    "pass a codebook at call time or bind a VQ instance.")
            codebook = self.vq.codebook
        return codebook[indices]


class MultiStageVectorQuantization(BaseNonFunctionalOp):
    """Residual VQ: x -> (xq, indices (..., Q), loss)."""

    def __init__(self, order: int, codebook_size: int, n_stage: int, *,
                 seed: int = 0, dtype=None, device=None, **kwargs) -> None:
        super().__init__()
        if n_stage <= 0:
            raise ValueError("n_stage must be positive.")
        self.order = order
        self.n_stage = n_stage
        dtype = dtype or torch.get_default_dtype()
        dev = resolve_device(device)
        keys = prng.split(prng.PRNGKey(seed), n_stage)
        self.codebooks = torch.nn.Parameter(torch.stack([
            initial_codebook(k, (codebook_size, order + 1), dtype, dev)
            for k in keys]))

    @property
    def codebook(self):
        return self.codebooks

    @full_precision
    @span("MultiStageVectorQuantization")
    def forward(self, x: torch.Tensor, codebooks=None):
        codebooks = self.codebooks if codebooks is None else codebooks
        check_size(x.shape[-1], self.order + 1, "dimension of input")
        residual = x
        quantized = torch.zeros_like(x)
        indices = []
        loss = 0.0
        for q in range(self.n_stage):
            xq, idx = _nearest(residual, codebooks[q])
            loss = loss + torch.mean(torch.square(xq.detach() - residual))
            residual = residual - xq.detach()
            quantized = quantized + xq
            indices.append(idx)
        quantized = x + (quantized - x).detach()
        return quantized, torch.stack(indices, dim=-1), loss / self.n_stage


class InverseMultiStageVectorQuantization(BaseNonFunctionalOp):
    """Cumulative codebook sum: indices (..., Q) -> xq."""

    def __init__(self,
                 msvq: MultiStageVectorQuantization | None = None) -> None:
        super().__init__()
        self.msvq = msvq

    @span("InverseMultiStageVectorQuantization")
    def forward(self, indices: torch.Tensor, codebooks=None) -> torch.Tensor:
        if codebooks is None:
            if self.msvq is None:
                raise ValueError(
                    "pass codebooks at call time or bind an MSVQ instance.")
            codebooks = self.msvq.codebooks
        out = 0.0
        for q in range(indices.shape[-1]):
            out = out + codebooks[q][indices[..., q]]
        return out
