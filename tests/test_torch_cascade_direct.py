"""The direct-form Taylor cascade, ``taylor_cascade_direct`` (the plain
version of the CUDA cascade kernel's arithmetic), against the JAX
package's folded cascade, on the CPU.

Float64: equal to ``diffsptk_tpu.kernels.mlsa_cascade.taylor_cascade_folded``
within the suite's rtol 1e-5 / atol 1e-8, on the tap-chunked and the
unchunked geometry, with advance 0 and > 0, and with c broadcast over the
batch.  Float32: the rms distance from float64 is no larger than the
folded twin's, on coefficients whose Taylor terms cancel (sum|c| of 4 to
6, as the IMLSA stage's are); measured here at 0.36 to 0.49 of the twin's.
Also the parts of the kernel's entry that need no card: its argument
checks, and an autograd node only where a gradient is asked for.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsptk_tpu.kernels.mlsa_cascade import (
    taylor_cascade_folded as j_folded,
)
from diffsptk_tpu_torch.kernels import mlsa
from diffsptk_tpu_torch.kernels.mlsa_cascade import (
    chunked_geometry,
    lane_aligned_nfft,
    taylor_cascade_direct,
    taylor_cascade_folded,
)

RTOL, ATOL = 1e-5, 1e-8


def _case(B, N, P, M, S, *, seed, decay=0.8, scale=0.3, shared=False):
    """x (B, N*P); c (B, N, M+1), or (N, M+1) shared by the batch; stage
    weights 1/s and Taylor coefficients 1, float64."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N * P))
    rows = 1 if shared else B
    base = rng.standard_normal((rows, 1, M + 1)) * decay ** np.arange(M + 1)
    c = base * (1 + 0.05 * rng.standard_normal((rows, N, M + 1))) * scale
    if shared:
        c = c[0]
    weights = np.insert(1.0 / np.arange(1, S + 1), 0, 1.0)
    return x, c, weights, np.ones(S + 1)


@pytest.mark.parametrize("B,N,P,M,S,advance,nfft,shared,chunked", [
    (2, 5, 16, 39, 4, 0, 510, False, True),
    (3, 5, 16, 39, 4, 5, 510, True, True),
    (2, 4, 80, 199, 3, 0, None, False, True),
    (2, 6, 18, 50, 3, 0, None, False, False),
    (3, 4, 18, 50, 3, 7, None, True, False),
    (1, 3, 240, 199, 3, 0, None, False, False),
])
def test_direct_matches_jax_folded_float64(B, N, P, M, S, advance, nfft,
                                           shared, chunked):
    """The folded form's two branches (nfft 510 makes P=16, M=39 take the
    tap-chunked one) against the direct FIR."""
    x, c, weights, a = _case(B, N, P, M, S, seed=P + M + advance,
                             shared=shared)
    nfft = nfft or lane_aligned_nfft(2 * P + M + 1)
    assert (chunked_geometry(M, P, nfft) is not None) == chunked
    want = j_folded(*map(jnp.asarray, (x, c, weights, a)), P, advance, nfft)
    got = taylor_cascade_direct(*map(torch.as_tensor, (x, c, weights, a)),
                                P, advance)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("N,P,M,S,nfft,seed", [
    (20, 80, 199, 20, None, 1),
    (20, 16, 39, 12, 510, 1),
    (20, 18, 50, 12, None, 4),
    (8, 240, 199, 20, None, 2),
])
def test_direct_float32_no_less_accurate_than_folded(N, P, M, S, nfft,
                                                     seed):
    x, c, weights, a = _case(2, N, P, M, S, seed=seed, decay=0.9,
                             scale=0.6 if P < 80 else 0.5)
    assert np.abs(c).sum(-1).max() > 4.0       # the Taylor terms cancel
    nfft = nfft or lane_aligned_nfft(2 * P + M + 1)
    t64 = [torch.as_tensor(v) for v in (x, c, weights, a)]
    t32 = [t.float() for t in t64]
    want = taylor_cascade_direct(*t64, P, 0)
    rms = [float((y.double() - want).pow(2).mean().sqrt()) for y in (
        taylor_cascade_direct(*t32, P, 0),
        taylor_cascade_folded(*t32, P, 0, nfft))]
    assert rms[0] <= rms[1], rms


def test_kernel_wrappers_check_their_arguments():
    """CPU tensors and transform lengths too short for the folded form are
    refused before anything is built or launched."""
    x, c, weights, a = map(torch.as_tensor, _case(1, 3, 16, 39, 2, seed=0))
    x = x.float().reshape(1, 3, 16)
    c = c.float()
    with pytest.raises(ValueError, match="CUDA"):
        mlsa.cascade_chunked_cuda(x, c, weights, a, 16, 0, 254)
    with pytest.raises(ValueError, match="CUDA"):
        mlsa.cascade_unchunked_cuda(x, c, weights, a, 16, 0, 128)
    with pytest.raises(ValueError, match="3P"):
        mlsa.cascade_chunked_cuda(x, c, weights, a, 16, 0, 40)
    with pytest.raises(ValueError, match="2P\\+M\\+1"):
        mlsa.cascade_unchunked_cuda(x, c, weights, a, 16, 0, 64)


def test_taylor_cascade_tracks_gradients_only_when_asked():
    """Without inputs that need a gradient the entry returns the folded
    twin's values with no autograd node; with them, the node whose
    backward differentiates the folded form."""
    x, c, weights, a = map(torch.as_tensor, _case(2, 4, 16, 39, 3, seed=1))
    nfft = lane_aligned_nfft(2 * 16 + 40)
    want = taylor_cascade_folded(x, c, weights, a, 16, 0, nfft)
    y = mlsa.taylor_cascade(x, c, weights, a, 16, 0, nfft)
    assert y.grad_fn is None
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert mlsa.taylor_cascade(xg, c, weights, a, 16, 0,
                                   nfft).grad_fn is None
    y = mlsa.taylor_cascade(xg, c, weights, a, 16, 0, nfft)
    assert type(y.grad_fn).__name__ == "TaylorCascadeBackward"
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=0)
