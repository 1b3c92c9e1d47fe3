"""The port's sharded filterbank battery (parallel/filterbanks.py) on eight
CPU ``gloo`` ranks against the JAX package's sharded classes over the same
mesh shapes (the eight virtual CPU devices of tests/conftest.py), and
against the port's one-rank ops, case for case as
tests/test_parallel_filterbanks.py holds the JAX package: PQMF and MDCT
over (1, 8), (2, 4) and (4, 2) at 1e-12, CQT and ICQT over (1, 2) and
(2, 2) at 1e-8, the float32 battery over (2, 4) at 1e-5
(tests/test_torch_parallel.py describes the ranks).  The MDCT's trailing
frame lives on the last time rank: ``shard`` / ``unshard`` with
``tail=1`` move it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import Pools, close, jax_mesh, t64

THIS = __name__
MESHES = [(1, 8), (2, 4), (4, 2)]
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = Pools(tmp_path_factory, THIS)
    yield pools
    pools.close()


def case_pqmf_mdct(ctx, x, mesh_shape, dtype):
    from diffsptk_tpu_torch.parallel import shard, unshard
    from diffsptk_tpu_torch.parallel.filterbanks import (
        ShardedIMDCT, ShardedIPQMF, ShardedMDCT, ShardedPQMF)
    mesh = ctx.mesh(mesh_shape)
    if mesh.get_coordinate() is None:
        return None
    dt = getattr(torch, dtype)
    kw = dict(device="cpu", dtype=dt)
    xb = shard(torch.as_tensor(x, dtype=dt), mesh)
    a = ShardedPQMF(mesh, 4, 47, **kw)(xb)
    s = ShardedIPQMF(mesh, 4, 47, **kw)(a)
    c = ShardedMDCT(mesh, 256, **kw)(xb)
    y = ShardedIMDCT(mesh, 256, **kw)(c)
    return (unshard(a, mesh).numpy(), unshard(s, mesh).numpy(),
            unshard(c, mesh, time_dim=-2).numpy(), unshard(y, mesh).numpy())


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_pqmf_and_mdct_match_jax(ranks, dp, tp):
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.filterbanks import (
        ShardedIMDCT, ShardedIPQMF, ShardedMDCT, ShardedPQMF)
    x = RNG.standard_normal((4, 4096))
    a, s, c, y = ranks("case_pqmf_mdct", x=x, mesh_shape=(dp, tp),
                       dtype="float64")
    jm = jax_mesh(dp, tp)
    ja = jax.jit(ShardedPQMF(jm, 4, 47))(x)
    jc = jax.jit(ShardedMDCT(jm, 256))(x)
    for got, want in ((a, ja), (s, jax.jit(ShardedIPQMF(jm, 4, 47))(ja)),
                      (c, jc), (y, jax.jit(ShardedIMDCT(jm, 256))(jc))):
        close(got, want, 1e-12, 1e-12)
    kw = dict(device="cpu", dtype=torch.float64)
    ra = pt.PQMF(4, 47, **kw)(t64(x))
    close(a, ra, 1e-12, 1e-12)
    close(s, pt.IPQMF(4, 47, **kw)(ra), 1e-12, 1e-12)
    rc = pt.MDCT(256, **kw)(t64(x))
    close(c, rc, 1e-12, 1e-12)
    close(y, pt.IMDCT(256, **kw)(rc), 1e-12, 1e-12)
    close(y, x, 1e-10, 1e-10)                 # perfect reconstruction


def test_sharded_battery_float32(ranks):
    """The battery at float32 over (2, 4): sharded equals one-rank within
    1e-5, and the JAX package's sharded float32 battery."""
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.filterbanks import (
        ShardedIMDCT, ShardedIPQMF, ShardedMDCT, ShardedPQMF)
    x = RNG.standard_normal((4, 4096)).astype(np.float32)
    a, s, c, y = ranks("case_pqmf_mdct", x=x, mesh_shape=(2, 4),
                       dtype="float32")
    kw = dict(device="cpu", dtype=torch.float32)
    xt = torch.as_tensor(x)
    ra = pt.PQMF(4, 47, **kw)(xt)
    close(a, ra, 1e-5, 1e-5)
    close(s, pt.IPQMF(4, 47, **kw)(ra), 1e-5, 1e-5)
    close(y, pt.IMDCT(256, **kw)(pt.MDCT(256, **kw)(xt)), 1e-5, 1e-5)
    jm = jax_mesh(2, 4)
    ja = jax.jit(ShardedPQMF(jm, 4, 47))(x)
    close(a, ja, 1e-5, 1e-5)
    close(s, jax.jit(ShardedIPQMF(jm, 4, 47))(ja), 1e-5, 1e-5)
    jc = jax.jit(ShardedMDCT(jm, 256))(x)
    close(y, jax.jit(ShardedIMDCT(jm, 256))(jc), 1e-5, 1e-5)


CQT_KW = dict(f_min=200.0, n_bin=24)


def case_cqt(ctx, x, mesh_shape):
    from diffsptk_tpu_torch.parallel import shard, unshard
    from diffsptk_tpu_torch.parallel.filterbanks import ShardedCQT
    mesh = ctx.mesh(mesh_shape)
    if mesh.get_coordinate() is None:
        return None
    op = ShardedCQT(mesh, 64, 16000, **CQT_KW, device="cpu",
                    dtype=torch.float64)
    return unshard(op(shard(t64(x), mesh)), mesh, time_dim=-2).numpy()


def case_icqt(ctx, c, mesh_shape):
    from diffsptk_tpu_torch.parallel import shard, unshard
    from diffsptk_tpu_torch.parallel.filterbanks import ShardedICQT
    mesh = ctx.mesh(mesh_shape)
    if mesh.get_coordinate() is None:
        return None
    op = ShardedICQT(mesh, 64, 16000, **CQT_KW, device="cpu",
                     dtype=torch.float64)
    return unshard(op(shard(torch.as_tensor(c), mesh, time_dim=-2)),
                   mesh).numpy()


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_sharded_cqt_matches_jax(ranks, dp, tp):
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.filterbanks import ShardedCQT
    jop = ShardedCQT(jax_mesh(dp, tp), 64, 16000, **CQT_KW)
    align = np.lcm(64, jop.dec_total) * tp
    T = int(-(-(2 * jop.halo * tp + 8 * 64 * tp) // align) * align)
    x = RNG.standard_normal((2, T))
    got = ranks("case_cqt", x=x, mesh_shape=(dp, tp))
    assert got.shape[-2] == T // 64
    close(got, jax.jit(jop)(x), 1e-8, 1e-10)
    ref = pt.CQT(64, 16000, **CQT_KW, device="cpu",
                 dtype=torch.float64)(t64(x))
    close(got, ref[..., :got.shape[-2], :], 1e-8, 1e-10)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_sharded_icqt_matches_jax(ranks, dp, tp):
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.filterbanks import ShardedICQT
    jop = ShardedICQT(jax_mesh(dp, tp), 64, 16000, **CQT_KW)
    N = max(2 * jop.Hf + 8, 64)
    N = -(-N // tp) * tp
    c = (RNG.standard_normal((2, N, 24))
         + 1j * RNG.standard_normal((2, N, 24)))
    got = ranks("case_icqt", c=c, mesh_shape=(dp, tp))
    close(got, jax.jit(jop)(c), 1e-8, 1e-10)
    ref = pt.ICQT(64, 16000, **CQT_KW, device="cpu",
                  dtype=torch.float64)(torch.as_tensor(c), out_length=N * 64)
    close(got, ref, 1e-8, 1e-10)
