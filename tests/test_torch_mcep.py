"""Port freqt, coefficient freqt, the masked Cholesky solve and
mel-cepstral analysis against the JAX package, float64 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-8, the repo's float64 parity tolerance
(tests/utils.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu.ops.freqt import FrequencyTransform as JFreqt
from diffsptk_tpu.ops.mcep import CoefficientsFrequencyTransform as JCoef
from diffsptk_tpu.ops.mcep import MelCepstralAnalysis as JMcep
from diffsptk_tpu.ops.stft import ShortTimeFourierTransform as JSTFT
from diffsptk_tpu.utils.linalg import spd_solve as jspd_solve
from diffsptk_tpu_torch.kernels import mcep_residual as mr
from diffsptk_tpu_torch.ops import mcep as mcep_ops
from diffsptk_tpu_torch.utils.linalg import spd_solve

RTOL, ATOL = 1e-5, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m1,m2,alpha", [(2, 3, 0.3), (24, 199, -0.42),
                                         (10, 4, 0.1)])
def test_freqt(m1, m2, alpha):
    c = np.random.default_rng(0).standard_normal((3, m1 + 1))
    _close(pt.FrequencyTransform(m1, m2, alpha, **F64)(torch.as_tensor(c)),
           JFreqt(m1, m2, alpha)(jnp.asarray(c)))


def test_coef_freqt():
    c = np.random.default_rng(1).standard_normal((4, 257))
    _close(pt.CoefficientsFrequencyTransform(256, 48, 0.42, **F64)(
        torch.as_tensor(c)), JCoef(256, 48, 0.42)(jnp.asarray(c)))


@pytest.mark.parametrize("n,batch", [(6, 20), (25, 4), (25, 30), (3, 2)])
def test_spd_solve(n, batch):
    """Both branches (batch-minor unroll, masked sweeps)."""
    rng = np.random.default_rng(2)
    G = rng.standard_normal((batch, n, n))
    A = G @ np.swapaxes(G, -1, -2) + n * np.eye(n)
    b = rng.standard_normal((batch, n))
    _close(spd_solve(torch.as_tensor(A), torch.as_tensor(b)),
           jspd_solve(jnp.asarray(A), jnp.asarray(b)))


@pytest.mark.parametrize("n_iter", [0, 10])
def test_mcep_flagship_config(n_iter):
    """M=24, alpha=0.42 on the STFT power spectrum of the vocoder."""
    x = np.random.default_rng(3).standard_normal((2, 1600))
    sp = np.asarray(JSTFT(400, 80, 512, eps=0, relative_floor=-80,
                          out_format="power")(jnp.asarray(x)))
    kw = dict(fft_length=512, cep_order=24, alpha=0.42, n_iter=n_iter)
    want = jax.jit(JMcep(**kw))(jnp.asarray(sp))
    got = pt.MelCepstralAnalysis(**kw, **F64)(torch.tensor(sp))
    _close(got, want)


def test_mcep_gradient_matches_jax():
    sp = np.abs(np.random.default_rng(4).standard_normal((3, 33))) + 0.1
    kw = dict(fft_length=64, cep_order=6, alpha=0.3, n_iter=3)
    jop = JMcep(**kw)
    want = jax.jit(jax.grad(lambda s: jnp.sum(jnp.sin(jop(s)))))(
        jnp.asarray(sp))
    s = torch.as_tensor(sp).requires_grad_(True)
    torch.sum(torch.sin(pt.MelCepstralAnalysis(**kw, **F64)(s))).backward()
    _close(s.grad, want, rtol=1e-6, atol=1e-9)


# The residual of the Newton step (kernels/mcep_residual.py): its plain
# twin, its autograd Function and the lane-major branch of mcep, float64 on
# the CPU.  The twin and the row-major composition differ by the order of
# float64 sums alone: rtol 1e-12.

def _residual_inputs(op, batch, seed):
    """mc_t (n, B) from the op's seed matmul on a positive spectrum, log_x
    (B, H+1) and the op's matrices."""
    rng = np.random.default_rng(seed)
    sp = np.abs(rng.standard_normal((batch, op.in_dim))) + 0.1
    log_x = torch.log(torch.as_tensor(sp))
    mc_t = torch.matmul(log_x, op.P0).T.contiguous()
    return mc_t, log_x, op.P1, op.P2, op.alpha_vector


def _row_major_residual(mc_t, log_x, P1, P2, av):
    """The CPU branch's arithmetic of mcep (ops/mcep.py), frames first."""
    D = torch.matmul(mc_t.T, P1)
    d = torch.exp(log_x - D - D)
    rt = torch.matmul(d, P2)
    return rt.T, (rt[:, :mc_t.shape[0]] - av).T


RESIDUAL_OPS = {
    "mcep16k": lambda: pt.MelCepstralAnalysis(
        fft_length=512, cep_order=24, alpha=0.42, n_iter=1, **F64),
    "mcep48k": lambda: pt.MelCepstralAnalysis(
        fft_length=2048, cep_order=24, alpha=0.55, n_iter=1, **F64),
    "smcep": lambda: pt.SecondOrderAllPassMelCepstralAnalysis(
        fft_length=512, cep_order=24, alpha=0.42, theta=0.1, n_iter=1,
        **F64),
    "mcep_small": lambda: pt.MelCepstralAnalysis(
        fft_length=64, cep_order=6, alpha=0.3, n_iter=1, **F64),
}


@pytest.mark.parametrize("name", sorted(RESIDUAL_OPS))
def test_mcep_residual_twin_equals_the_composition(name):
    args = _residual_inputs(RESIDUAL_OPS[name](), 37, 5)
    got = mr.mcep_residual_plain(*args)
    for g, w in zip(got, _row_major_residual(*args), strict=True):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    before = mr.launches
    torch.testing.assert_close(mr.mcep_residual_lane_major(*args), got,
                               rtol=0, atol=0)
    assert mr.launches == before


@pytest.mark.parametrize("learnable", [True, False])
def test_mcep_residual_gradients_match_autograd(learnable):
    """The Function's backward (D and d recomputed) against autograd
    through the plain composition; with ``learnable`` the matrices and av
    take gradients too, otherwise only mc_t and log_x."""
    args = _residual_inputs(RESIDUAL_OPS["mcep_small"](), 11, 6)
    leaves = [a.clone().requires_grad_(learnable or i < 2)
              for i, a in enumerate(args)]
    rng = np.random.default_rng(7)
    w_rt, w_ra = (torch.as_tensor(rng.standard_normal(s))
                  for s in ((13, 11), (7, 11)))

    def loss(f):
        rt, ra = f(*leaves)
        return (w_rt * rt).sum() + (w_ra * torch.sin(ra)).sum()

    got = torch.autograd.grad(loss(mr.mcep_residual),
                              [a for a in leaves if a.requires_grad])
    want = torch.autograd.grad(loss(mr.mcep_residual_plain),
                               [a for a in leaves if a.requires_grad])
    assert len(got) == (5 if learnable else 2)
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


def test_mcep_residual_gradcheck():
    rng = np.random.default_rng(8)
    n, B, F = 3, 4, 6
    leaves = [torch.as_tensor(rng.standard_normal(s) * c).requires_grad_()
              for s, c in (((n, B), 0.1), ((B, F), 0.1), ((n, F), 0.3),
                           ((F, 2 * n - 1), 0.3), ((n,), 1.0))]
    assert torch.autograd.gradcheck(mr.mcep_residual, leaves)


def test_mcep_residual_rejects_mismatched_shapes():
    mc_t, log_x, P1, P2, av = _residual_inputs(RESIDUAL_OPS["mcep_small"](),
                                               5, 9)
    bad = {"log_x rows": (mc_t, log_x[:4], P1, P2, av),
           "P1": (mc_t, log_x, P1[:, :-1], P2, av),
           "P2": (mc_t, log_x, P1, P2[:, :-1], av),
           "av": (mc_t, log_x, P1, P2, av[:-1]),
           "dtype": (mc_t, log_x.float(), P1, P2, av),
           "mc_t rank": (mc_t[0], log_x, P1, P2, av)}
    for what, args in bad.items():
        with pytest.raises(ValueError):
            mr.mcep_residual_lane_major(*args)
        with pytest.raises(ValueError):
            mr.mcep_residual(*args)


@pytest.mark.parametrize("name", ["mcep16k", "smcep"])
def test_mcep_lane_major_branch_on_the_cpu(name, monkeypatch):
    """The card's branch of mcep (the residual, the Newton solve, the
    lane-major layout) run through the twins on the CPU equals the CPU
    branch, values and gradients."""
    op = RESIDUAL_OPS[name]()
    op.n_iter = 4
    sp = np.abs(np.random.default_rng(10).standard_normal((2, 3, 257)))
    x = torch.as_tensor(sp + 0.1).requires_grad_(True)
    want = op(x)
    (g_want,) = torch.autograd.grad(torch.sin(want).sum(), x)
    monkeypatch.setattr(mcep_ops, "_use_newton_kernel", lambda x, n: True)
    got = op(x)
    (g_got,) = torch.autograd.grad(torch.sin(got).sum(), x)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(g_got, g_want, rtol=1e-8, atol=1e-10)


def test_mcep_residual_launch_counts_nothing_at_zero_frames(monkeypatch):
    """No frames: the wrapper returns empty outputs without calling the C
    entry, and the launch counter stays where it was."""
    n, F = 5, 9
    called = []
    monkeypatch.setattr(mr.build, "launch",
                        lambda *a, **k: called.append(a))
    f32 = dict(dtype=torch.float32)
    args = (torch.zeros(n, 0, **f32), torch.zeros(0, F, **f32),
            torch.zeros(n, F, **f32), torch.zeros(F, 2 * n - 1, **f32),
            torch.zeros(n, **f32))
    before = mr.launches
    rt_t, ra_t = mr._launch(*args, n, 0, F)
    assert (tuple(rt_t.shape), tuple(ra_t.shape)) == ((2 * n - 1, 0), (n, 0))
    assert mr.launches == before and not called
