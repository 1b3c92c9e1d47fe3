"""The port's learners and vector quantizers against the JAX package on
the CPU: the initial codebooks, means and factors drawn from a seed
(JAX's generator: the uniform factors of NMF equal bit for bit, the
normal draws within three ulps at float32 and rtol 1e-10 at float64,
the most that 1.6 million draws of eight seeds showed, as ROADMAP C.13
pins: JAX's float normals take XLA's own log1p), VQ and
multi-stage VQ on one codebook, GMM after a fixed number of EM
iterations with ``eps=0`` (diagonal, full and block covariance, MAP
adaptation from a UBM, streaming by ``batch_size``, the LBG warm start,
the regression of ``transform``), LBG's codebook and indices (streamed
too), PCA up to one sign per component, ICA, NMF for each beta that
tests/test_learners.py takes and its ``transform``, the interrupted and
resumed GMM fit through a checkpoint of either package, and the JSONL
metrics callback.

Tolerances: rtol 1e-5 / atol 1e-8 at float64 and 1e-4 / 1e-6 at float32
(tests/utils.py).  Two float32 cases hold the port to the JAX package's
float64 instead of its float32, at the float32 tolerance: PCA, whose
float32 eigenvectors in the JAX package lie 1.2e-6 from its float64 (the
port's 2.9e-7), and the GMM's LBG warm start, which the JAX package runs
in its default dtype (float64 under x64) whatever the GMM's; there the
log-probabilities of ``transform``, which cross zero, are held within
1e-5 of their max|y| (read: 1.1e-6).  Each JAX reference runs once per
case."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffsptk_tpu as dsp
import diffsptk_tpu_torch as pt
from diffsptk_tpu.utils import checkpoint as jckpt
from diffsptk_tpu_torch.ops.learners import as_chunks, cluster_sums
from diffsptk_tpu_torch.utils import checkpoint as tckpt
from diffsptk_tpu_torch.utils.metrics import JsonlMetricsLogger

TOL = {torch.float64: (1e-5, 1e-8), torch.float32: (1e-4, 1e-6)}
J_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DTYPES = [torch.float64, torch.float32]
RNG = np.random.default_rng(71)


def _clusters(n=200, d=3, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n // 2, d)) * 0.3 + np.eye(d)[0] * 2
    b = rng.standard_normal((n // 2, d)) * 0.5 - np.eye(d)[0] * 2 + 1
    return np.concatenate([a, b])


X2 = _clusters()                                  # (200, 3)
XJ = _clusters(120, 4, seed=1)                    # joint vectors, (120, 4)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, dtype, rtol=None, atol=None):
    r, a = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=rtol or r, atol=atol or a)


def _same_draw(got, want, dtype):
    """The port's normal draw against JAX's: three ulps at float32, rtol
    1e-10 at float64 (ROADMAP C.13)."""
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype
    if dtype == torch.float32:
        np.testing.assert_array_max_ulp(got, want, maxulp=3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


CPU = dict(device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_initial_draws(dtype):
    """Codebooks, means and ICA's W from the seed; NMF's factors (uniform
    draws) bit for bit."""
    jd = J_DTYPE[dtype]
    kw = dict(CPU, dtype=dtype)
    _same_draw(pt.VectorQuantization(4, 16, seed=3, **kw).codebook,
               dsp.VectorQuantization(4, 16, seed=3, dtype=jd).codebook,
               dtype)
    _same_draw(pt.MultiStageVectorQuantization(4, 8, 3, seed=2,
                                               **kw).codebooks,
               dsp.MultiStageVectorQuantization(4, 8, 3, seed=2,
                                                dtype=jd).codebooks, dtype)
    _same_draw(pt.GMM(5, 4, seed=7, **kw).mu,
               dsp.GMM(5, 4, seed=7, dtype=jd).mu, dtype)
    _same_draw(pt.LBG(3, 8, seed=4, **kw).vq.codebook,
               dsp.LBG(3, 8, seed=4, dtype=jd).vq.codebook, dtype)
    _same_draw(pt.ICA(3, 3, seed=9, **kw).W,
               dsp.ICA(3, 3, seed=9, dtype=jd).W, dtype)
    for act_norm in (False, True):
        got = pt.NMF(30, 5, 3, seed=1, act_norm=act_norm, **kw)
        want = dsp.NMF(30, 5, 3, seed=1, act_norm=act_norm, dtype=jd)
        if act_norm:
            _close(got.U, want.U, dtype, rtol=1e-15, atol=0)
        else:
            np.testing.assert_array_equal(_np(got.U), np.asarray(want.U))
        np.testing.assert_array_equal(_np(got.H), np.asarray(want.H))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vq_and_msvq(dtype):
    """On one codebook (the JAX package's), the same quantized vectors,
    indices and commitment loss; the inverses rebuild the output; the
    straight-through gradient is one."""
    jd = J_DTYPE[dtype]
    x = RNG.standard_normal((2, 10, 4))
    jvq = dsp.VectorQuantization(3, 8, seed=1, dtype=jd)
    vq = pt.VectorQuantization(3, 8, seed=1, device="cpu", dtype=dtype)
    with torch.no_grad():
        vq.codebook.copy_(torch.as_tensor(np.asarray(jvq.codebook)))
    want = jvq(jnp.asarray(x, jd))
    xt = torch.as_tensor(x, dtype=dtype).requires_grad_(True)
    got = vq(xt)
    _close(got[0], want[0], dtype)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    _close(got[2], want[2], dtype)
    got[0].sum().backward()
    assert torch.all(xt.grad == 1)
    _close(pt.InverseVectorQuantization(vq)(got[1]), got[0], dtype)
    _close(pt.InverseVectorQuantization()(got[1], vq.codebook), got[0],
           dtype)

    jms = dsp.MultiStageVectorQuantization(3, 8, 3, seed=2, dtype=jd)
    ms = pt.MultiStageVectorQuantization(3, 8, 3, seed=2, device="cpu",
                                         dtype=dtype)
    with torch.no_grad():
        ms.codebooks.copy_(torch.as_tensor(np.asarray(jms.codebooks)))
    want = jms(jnp.asarray(x, jd))
    got = ms(torch.as_tensor(x, dtype=dtype))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, dtype)
    _close(got[2], want[2], dtype)
    _close(pt.InverseMultiStageVectorQuantization(ms)(got[1]), got[0],
           dtype)


def _gmm_pair(dtype, *args, ubm=None, **kw):
    """The port's GMM and the JAX package's, from the JAX package's
    initial means (the port's own are within an ulp: C.13)."""
    jd = J_DTYPE[dtype]
    jg = dsp.GMM(*args, ubm=ubm, dtype=jd, **kw)
    tg = pt.GMM(*args, ubm=None if ubm is None else tuple(
        np.asarray(u) for u in ubm), device="cpu", dtype=dtype, **kw)
    tg.set_params((None, np.asarray(jg.mu), None))
    return jg, tg


GMM_CASES = {
    "diag": ((2, 3), dict(n_iter=6, eps=0, seed=5), X2),
    "full": ((2, 3), dict(n_iter=6, eps=0, seed=5, var_type="full"), X2),
    "block": ((3, 2), dict(n_iter=5, eps=0, seed=2, var_type="full",
                           block_size=[2, 2]), XJ),
    "block-diag": ((3, 2), dict(n_iter=5, eps=0, seed=2,
                                block_size=[2, 2]), XJ),
    "stream": ((2, 3), dict(n_iter=6, eps=0, seed=5, var_type="full",
                            batch_size=64), X2),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_matches_jax(case, dtype):
    args, kw, x = GMM_CASES[case]
    jg, tg = _gmm_pair(dtype, *args, **kw)
    jd = J_DTYPE[dtype]
    (jw, jmu, jsig), jll = jg(jnp.asarray(x, jd))
    (tw, tmu, tsig), tll = tg(torch.as_tensor(x, dtype=dtype))
    for g, w in ((tw, jw), (tmu, jmu), (tsig, jsig)):
        _close(g, w, dtype)
    _close(tll, jll, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmm_map_adaptation_and_posterior(dtype):
    """MAP adaptation from a UBM (diagonal and full), streamed, and the
    posterior of ``return_posterior``."""
    jd = J_DTYPE[dtype]
    ubm, _ = dsp.GMM(2, 2, n_iter=5, seed=5, dtype=jd)(jnp.asarray(X2, jd))
    y = X2[:120]
    for var_type in ("diag", "full"):
        jg, tg = _gmm_pair(dtype, 2, 2, n_iter=4, eps=0, ubm=ubm,
                           alpha=0.3, var_type=var_type, batch_size=50)
        (jw, jmu, jsig), jpost, _ = jg(jnp.asarray(y, jd),
                                       return_posterior=True)
        (tw, tmu, tsig), tpost, _ = tg(torch.as_tensor(y, dtype=dtype),
                                       return_posterior=True)
        for g, w in ((tw, jw), (tmu, jmu), (tsig, jsig), (tpost, jpost)):
            _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gmm_warmup_and_transform(dtype):
    """The LBG warm start, a full-covariance fit of joint vectors, then
    ``transform``'s class, log-probability and regression from the first
    half."""
    jd = jnp.float64          # the JAX package's warm start is float64
    jg, _ = _gmm_pair(torch.float64, 3, 2, n_iter=5, eps=0,
                      var_type="full")
    _, tg = _gmm_pair(dtype, 3, 2, n_iter=5, eps=0, var_type="full")
    jg.warmup(jnp.asarray(XJ, jd), n_iter=10)
    tg.warmup(torch.as_tensor(XJ, dtype=dtype), n_iter=10)
    for g, w in ((tg.w, jg.w), (tg.mu, jg.mu), (tg.sigma, jg.sigma)):
        _close(g, w, dtype)
    jg(jnp.asarray(XJ, jd))
    tg(torch.as_tensor(XJ, dtype=dtype))
    want = jg.transform(jnp.asarray(XJ[:30, :2], jd))
    got = tg.transform(torch.as_tensor(XJ[:30, :2], dtype=dtype))
    _close(got[0], want[0], dtype)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    if dtype == torch.float32:     # log-densities cross zero: of max|y|
        err = np.abs(_np(got[2]) - np.asarray(want[2])).max()
        assert err <= 1e-5 * np.abs(np.asarray(want[2])).max(), err
    else:
        _close(got[2], want[2], dtype)
    none, idx, lp = tg.transform(torch.as_tensor(XJ, dtype=dtype))
    assert none is None and idx.shape == (120,) and lp.shape == (120,)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch_size", [None, 77])
def test_lbg_matches_jax(batch_size, dtype):
    """Codebook, indices and distance, from the JAX package's initial
    codebook, streamed or not (float32 on separated clusters)."""
    jd = J_DTYPE[dtype]
    if dtype == torch.float64:
        x = _clusters(300, 3, seed=3)
    else:
        # eight separated clusters, one a codeword: on overlapping ones an
        # assignment at a float32 near-tie goes either way in either
        # package, and the Lloyd steps carry it on (chunks of 77, 6
        # iterations: 9 of 24 codebook values moved by up to 0.029)
        rng = np.random.default_rng(3)
        centres = 4 * np.array([[i & 1, (i >> 1) & 1, i >> 2]
                                for i in range(8)], float)
        x = (centres[rng.integers(0, 8, 300)]
             + 0.3 * rng.standard_normal((300, 3)))
    kw = dict(n_iter=6, seed=2, batch_size=batch_size)
    jl = dsp.LBG(2, 8, **kw, dtype=jd)
    tl = pt.LBG(2, 8, **kw, device="cpu", dtype=dtype)
    with torch.no_grad():
        tl.vq.codebook.copy_(torch.as_tensor(np.asarray(jl.vq.codebook)))
    jcb, jidx, jd_ = jl(jnp.asarray(x, jd), return_indices=True)
    tcb, tidx, td = tl(torch.as_tensor(x, dtype=dtype), return_indices=True)
    _close(tcb, jcb, dtype)
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    _close(td, jd_, dtype)
    xq, idx = tl.transform(torch.as_tensor(x, dtype=dtype))
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))


def test_lbg_starved_clusters_and_given_init():
    """Clusters below ``min_data_per_cluster`` are re-seeded from the
    fullest; an initial codebook of a power-of-two fraction is taken."""
    x = _clusters(200, 3, seed=4)
    init = x[:2]
    jl = dsp.LBG(2, 8, n_iter=4, min_data_per_cluster=30, init=init,
                 seed=1)
    tl = pt.LBG(2, 8, n_iter=4, min_data_per_cluster=30, init=init,
                seed=1, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        tl.vq.codebook.copy_(torch.as_tensor(np.asarray(jl.vq.codebook)))
    jcb, jd_ = jl(jnp.asarray(x))
    tcb, td = tl(torch.as_tensor(x))
    _close(tcb, jcb, torch.float64, rtol=1e-6, atol=1e-8)
    _close(td, jd_, torch.float64)
    with pytest.raises(ValueError):
        pt.LBG(2, 8, init=x[:3], device="cpu")


def test_cluster_sums_match_index_add():
    idx = torch.as_tensor(RNG.integers(0, 6, 50))
    x = torch.as_tensor(RNG.standard_normal((50, 3)))
    n, s = cluster_sums(idx, x, 6)
    assert n.dtype == torch.int64
    torch.testing.assert_close(n, torch.bincount(idx, minlength=6))
    torch.testing.assert_close(s, torch.zeros(6, 3, dtype=x.dtype)
                               .index_add_(0, idx, x))


def _sign_fixed(V):
    V = _np(V)
    return V * np.sign(V[:, :1] + 1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cov_type,sort", [("sample", "descending"),
                                           ("unbiased", "ascending"),
                                           ("correlation", "descending")])
def test_pca_matches_jax(cov_type, sort, dtype):
    """Eigenvalues and means directly; eigenvectors and projections up
    to one sign per component (float32 against the JAX package's
    float64)."""
    jd = jnp.float64
    x = XJ
    jp = dsp.PCA(3, 3, cov_type=cov_type, sort=sort, batch_size=50,
                 dtype=jd)
    tp = pt.PCA(3, 3, cov_type=cov_type, sort=sort, batch_size=50,
                device="cpu", dtype=dtype)
    js, jV, jm = jp(jnp.asarray(x, jd))
    ts, tV, tm = tp(torch.as_tensor(x, dtype=dtype))
    _close(ts, js, dtype)
    _close(tm, jm, dtype)
    sign = np.sign(_np(tV)[:, 0]) * np.sign(np.asarray(jV)[:, 0])
    _close(_np(tV) * sign[:, None], jV, dtype)
    xt = torch.as_tensor(x[:20], dtype=dtype)
    order = slice(None, None, -1) if sort == "ascending" else slice(None)
    _close(_np(tp.transform(xt)) * sign[order],
           jp.transform(jnp.asarray(x[:20], jd)), dtype)
    _close(_np(tp.whiten(tp.center(xt))) * sign[order],
           jp.whiten(jp.center(jnp.asarray(x[:20], jd))), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("func", ["logcosh", "gauss"])
def test_ica_matches_jax(func, dtype):
    """FastICA from the JAX package's initial W on two mixed sources,
    streamed; the unmixing matrix up to the PCA's signs (the symmetric
    decorrelation does not depend on them)."""
    jd = J_DTYPE[dtype]
    t = np.linspace(0, 1, 600)
    S = np.stack([np.sign(np.sin(26 * np.pi * t)), np.sin(14 * np.pi * t)],
                 -1)
    mix = S @ np.array([[1.0, 0.6], [0.4, 1.0]]).T
    ji = dsp.ICA(1, 2, func=func, n_iter=20, seed=3, batch_size=256,
                 dtype=jd)
    ti = pt.ICA(1, 2, func=func, n_iter=20, seed=3, batch_size=256,
                device="cpu", dtype=dtype)
    ti.W = torch.as_tensor(np.asarray(ji.W))
    jW = np.asarray(ji(jnp.asarray(mix, jd)))
    tW = ti(torch.as_tensor(mix, dtype=dtype))
    sign = np.sign(_np(ti.pca.V)[:, 0]) * np.sign(np.asarray(ji.pca.V)[:, 0])
    _close(_np(tW) * sign[None, :], jW, dtype)
    _close(ti.transform(torch.as_tensor(mix[:50], dtype=dtype)),
           ji.transform(jnp.asarray(mix[:50], jd)), dtype)


Z = RNG.uniform(0.1, 1, (40, 3)) @ RNG.uniform(0.1, 1, (3, 6))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beta", [0, 1, 2])
def test_nmf_matches_jax(beta, dtype):
    """Multiplicative updates from the same uniform factors (drawn by
    each package from the seed), streamed, and the divergence."""
    jd = J_DTYPE[dtype]
    kw = dict(beta=beta, n_iter=20, seed=1, batch_size=16)
    jn = dsp.NMF(40, 5, 3, **kw, dtype=jd)
    tn = pt.NMF(40, 5, 3, **kw, device="cpu", dtype=dtype)
    (jU, jH), jdiv = jn(jnp.asarray(Z, jd))
    (tU, tH), tdiv = tn(torch.as_tensor(Z, dtype=dtype))
    _close(tU, jU, dtype)
    _close(tH, jH, dtype)
    _close(tdiv, jdiv, dtype)
    _close(tn.transform(torch.as_tensor(Z[:7], dtype=dtype)),
           jn.transform(jnp.asarray(Z[:7], jd)), dtype)


def test_nmf_act_norm_and_checks():
    jn = dsp.NMF(40, 5, 3, act_norm=True, beta=0.5, n_iter=5, seed=2)
    tn = pt.NMF(40, 5, 3, act_norm=True, beta=0.5, n_iter=5, seed=2,
                device="cpu", dtype=torch.float64)
    (jU, jH), _ = jn(jnp.asarray(Z))
    (tU, tH), _ = tn(torch.as_tensor(Z))
    _close(tU, jU, torch.float64)
    _close(tH, jH, torch.float64)
    with pytest.raises(ValueError):
        tn(torch.as_tensor(-Z))
    with pytest.raises(ValueError):
        tn(torch.as_tensor(Z[:30]))


def test_as_chunks():
    x = np.arange(20.0).reshape(10, 2)
    chunks = as_chunks(x, 4, device="cpu", dtype=torch.float32)
    assert [c.shape[0] for c in chunks] == [4, 4, 2]
    assert all(c.dtype == torch.float32 for c in chunks)
    assert len(as_chunks([x[:3], torch.as_tensor(x[3:])], None)) == 2
    with pytest.raises(ValueError):
        as_chunks([], None)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_gmm_interrupt_resume(tmp_path, writer):
    """tests/test_learners.py:205 in the port: a fit stopped by its
    callback after four iterations, checkpointed by either package,
    loaded by the port into a new GMM and continued for six, equals the
    uninterrupted fit of ten (and the JAX package's)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(-2, 0.5, (80, 3)),
                        rng.normal(+2, 0.8, (80, 3))])
    xt = torch.as_tensor(x)
    full = pt.GMM(2, 2, n_iter=10, eps=0, seed=5, device="cpu",
                  dtype=torch.float64)
    (w_ref, mu_ref, s_ref), _ = full(xt)
    (jw, jmu, js), _ = dsp.GMM(2, 2, n_iter=10, eps=0, seed=5)(
        jnp.asarray(x))
    _close(mu_ref, jmu, torch.float64)

    path = str(tmp_path / "gmm_ckpt.npz")
    save = jckpt.save if writer == "jax" else tckpt.save

    def stop_after_4(iteration, params, **kv):
        if iteration == 3:
            tree = {"w": params[0], "mu": params[1], "sigma": params[2]}
            if writer == "jax":
                tree = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
                save(path, tree, backend="npz")
            else:
                save(path, tree)
            return False
        return True

    pt.GMM(2, 2, n_iter=10, eps=0, seed=5, device="cpu",
           dtype=torch.float64)(xt, callback=stop_after_4)
    resumed = pt.GMM(2, 2, n_iter=6, eps=0, seed=99, device="cpu",
                     dtype=torch.float64)
    ckpt = tckpt.load(path, {"w": resumed.w, "mu": resumed.mu,
                             "sigma": resumed.sigma})
    resumed.set_params((ckpt["w"], ckpt["mu"], ckpt["sigma"]))
    (w, mu, s), _ = resumed(xt)
    np.testing.assert_allclose(_np(w), _np(w_ref), rtol=1e-10)
    np.testing.assert_allclose(_np(mu), _np(mu_ref), rtol=1e-10)
    np.testing.assert_allclose(_np(s), _np(s_ref), rtol=1e-9)


def test_learner_state_and_metrics(tmp_path):
    """Learned state is buffers (``state_dict`` carries it); the JSONL
    callback logs one scalar event per iteration of GMM, NMF and LBG."""
    import json

    g = pt.GMM(3, 2, n_iter=3, eps=0, seed=0, device="cpu")
    assert {"w", "mu", "sigma", "mask"} <= set(g.state_dict())
    x = torch.as_tensor(np.abs(RNG.normal(1, 0.2, (32, 4))) + 0.1,
                        dtype=torch.float32)
    path = str(tmp_path / "metrics.jsonl")
    log = JsonlMetricsLogger(path)
    g(x, callback=log.as_callback())
    pt.NMF(32, 3, 2, n_iter=3, device="cpu")(x, callback=log.as_callback())
    pt.LBG(3, 2, n_iter=3, device="cpu")(x, callback=log.as_callback())
    log.close()
    events = [json.loads(line) for line in open(path)]
    assert len(events) >= 9
    assert all("t" in e and "iteration" in e for e in events)
    assert any("log_likelihood" in e for e in events)
    assert any("distance" in e for e in events)
    assert any("divergence" in e for e in events)
