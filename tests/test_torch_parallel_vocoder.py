"""The port's sharded mel-cepstral vocoder (parallel/vocoder.py) on eight
CPU ``gloo`` ranks against the JAX package's sharded vocoder on the same
mesh shapes (the eight virtual CPU devices of tests/conftest.py), in
float64, and against the port's one-rank MelCepstralVocoder, as
tests/test_parallel.py holds the JAX package: the round trip at 1e-8 on
synthetic speech (never ``data.wav``), the synthesis's gradient against
``jax.grad``, the bulk halo against the per-stage one at 1e-10 and the
one-rank synthesis at 1e-8, and the bulk halo's gradient against
``jax.grad`` (tests/test_torch_parallel.py describes the ranks)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import Pools, close, jax_mesh, speech, t64

THIS = __name__


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = Pools(tmp_path_factory, THIS)
    yield pools
    pools.close()


VOC_KW = dict(frame_length=400, frame_period=80, fft_length=512,
              cep_order=24, alpha=0.42, n_iter=3)


def case_vocoder(ctx, x, mesh_shape):
    from diffsptk_tpu_torch.parallel import (ShardedMelCepstralVocoder,
                                             shard, unshard)
    mesh = ctx.mesh(mesh_shape)
    voc = ShardedMelCepstralVocoder(mesh, **VOC_KW, device="cpu",
                                    dtype=torch.float64)
    xb = shard(t64(x), mesh)
    y = voc.analysis_synthesis(xb)
    mc = voc.analyze(xb)
    return (unshard(y, mesh).numpy(),
            unshard(mc, mesh, time_dim=-2).numpy())


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_vocoder_matches_jax(ranks, mesh_shape):
    """N ranks equal the JAX package's sharded vocoder and the port's
    one-rank MelCepstralVocoder at rtol 1e-8, on synthetic speech."""
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.vocoder import ShardedMelCepstralVocoder
    x = speech(2, 9600)
    want = jax.jit(ShardedMelCepstralVocoder(
        jax_mesh(*mesh_shape), **VOC_KW).analysis_synthesis)(x)
    got, mc = ranks("case_vocoder", x=x, mesh_shape=mesh_shape)
    scale = float(np.abs(np.asarray(want)).max())
    close(got, want, 1e-8, 1e-10 * scale)
    single = pt.MelCepstralVocoder(**VOC_KW, device="cpu",
                                   dtype=torch.float64)
    close(got, single.analysis_synthesis(t64(x)), 1e-8, 1e-10 * scale)
    close(mc, single.analyze(t64(x)), 1e-8, 1e-10)


GRAD_KW = dict(frame_length=32, frame_period=8, fft_length=32, cep_order=4,
               cep_order_mlsa=16, taylor_order=4, n_iter=2)


def case_vocoder_grad(ctx, e, mc, target):
    from diffsptk_tpu_torch.parallel import (ShardedMelCepstralVocoder,
                                             shard, unshard)
    mesh = ctx.mesh((2, 4))
    voc = ShardedMelCepstralVocoder(mesh, **GRAD_KW, device="cpu",
                                    dtype=torch.float64)
    mcb = shard(t64(mc), mesh, time_dim=-2).clone().requires_grad_(True)
    y = voc.synthesize(shard(t64(e), mesh), mcb)
    # this rank's share of the global mean
    loss = ((y - shard(t64(target), mesh)) ** 2).sum() / target.size
    loss.backward()
    return unshard(mcb.grad, mesh, time_dim=-2).numpy()


def test_sharded_vocoder_synthesis_grad_matches_jax(ranks):
    """The gradient of the synthesis's mean squared error with respect to
    the mel-cepstra, through every stage's halo exchange: equal to
    jax.grad of the JAX package's sharded synthesis and to the one-rank
    port's, rtol 1e-8."""
    import jax
    import jax.numpy as jnp

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.vocoder import ShardedMelCepstralVocoder
    rng = np.random.default_rng(0)
    e = rng.standard_normal((2, 512))
    mc = 0.01 * rng.standard_normal((2, 64, 5))
    target = rng.standard_normal((2, 512))
    voc = ShardedMelCepstralVocoder(jax_mesh(2, 4), **GRAD_KW)
    want = jax.jit(jax.grad(
        lambda m: jnp.mean((voc.synthesize(e, m) - target) ** 2)))(mc)
    got = ranks("case_vocoder_grad", e=e, mc=mc, target=target)
    assert np.abs(got).max() > 0
    close(got, want, 1e-8, 1e-12 * np.abs(want).max())
    single = pt.MelCepstralVocoder(**GRAD_KW, device="cpu",
                                   dtype=torch.float64)
    m = t64(mc).requires_grad_(True)
    ((single.synthesize(t64(e), m) - t64(target)) ** 2).mean().backward()
    close(got, m.grad, 1e-8, 1e-12 * np.abs(want).max())


def case_bulk(ctx, e, mc, mesh_shape):
    from diffsptk_tpu_torch.parallel import (ShardedMelCepstralVocoder,
                                             shard, unshard)
    mesh = ctx.mesh(mesh_shape)
    voc = ShardedMelCepstralVocoder(mesh, taylor_order=4,
                                    cep_order_mlsa=99, device="cpu",
                                    dtype=torch.float64)
    eb, mcb = shard(t64(e), mesh), shard(t64(mc), mesh, time_dim=-2)
    return tuple(unshard(voc.synthesize(eb, mcb, halo=h), mesh).numpy()
                 for h in ("per-stage", "bulk"))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_mlsa_bulk_halo_matches_per_stage(ranks, mesh_shape):
    """The bulk halo (one exchange for all S stages) equals the per-stage
    halo at 1e-10 and the port's one-rank synthesis at 1e-8 (the
    per-stage path is held to the JAX package's above)."""
    import diffsptk_tpu_torch as pt
    rng = np.random.default_rng(9)
    T = 80 * mesh_shape[1] * 16           # 16 frames a time rank
    e = rng.standard_normal((2, T))
    single = pt.MelCepstralVocoder(taylor_order=4, cep_order_mlsa=99,
                                   device="cpu", dtype=torch.float64)
    mc = single.analyze(t64(e)).numpy()   # any realistic mel-cepstra
    stage, bulk = ranks("case_bulk", e=e, mc=mc, mesh_shape=mesh_shape)
    scale = float(np.abs(stage).max())
    close(bulk, stage, 1e-10, 1e-12 * scale)
    close(stage, single.synthesize(t64(e), t64(mc)), 1e-8, 1e-10 * scale)


def case_bulk_grad(ctx, e, mc, target, mesh_shape):
    from diffsptk_tpu_torch.parallel import (ShardedMelCepstralVocoder,
                                             shard, unshard)
    mesh = ctx.mesh(mesh_shape)
    voc = ShardedMelCepstralVocoder(mesh, **GRAD_KW, device="cpu",
                                    dtype=torch.float64)
    mcb = shard(t64(mc), mesh, time_dim=-2).clone().requires_grad_(True)
    y = voc.synthesize(shard(t64(e), mesh), mcb, halo="bulk")
    # this rank's share of the global mean
    loss = ((y - shard(t64(target), mesh)) ** 2).sum() / target.size
    loss.backward()
    return unshard(mcb.grad, mesh, time_dim=-2).numpy()


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_mlsa_bulk_halo_grad_matches_jax(ranks, mesh_shape):
    """The gradient of the bulk-halo synthesis's mean squared error with
    respect to the mel-cepstra, through its one exchange of the whole
    cascade's reach and the edge-replicated coefficient halo: equal to
    jax.grad of the JAX package's bulk synthesis and to the one-rank
    port's, rtol 1e-8 (at least 16 frames a rank: the 4-stage reach is
    12)."""
    import jax
    import jax.numpy as jnp

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.vocoder import ShardedMelCepstralVocoder
    rng = np.random.default_rng(3)
    e = rng.standard_normal((2, 1024))
    mc = 0.01 * rng.standard_normal((2, 128, 5))
    target = rng.standard_normal((2, 1024))
    voc = ShardedMelCepstralVocoder(jax_mesh(*mesh_shape), **GRAD_KW)
    want = jax.jit(jax.grad(lambda m: jnp.mean(
        (voc.synthesize(e, m, halo="bulk") - target) ** 2)))(mc)
    got = ranks("case_bulk_grad", e=e, mc=mc, target=target,
                mesh_shape=mesh_shape)
    assert np.abs(got).max() > 0
    close(got, want, 1e-8, 1e-12 * np.abs(want).max())
    single = pt.MelCepstralVocoder(**GRAD_KW, device="cpu",
                                   dtype=torch.float64)
    m = t64(mc).requires_grad_(True)
    ((single.synthesize(t64(e), m) - t64(target)) ** 2).mean().backward()
    close(got, m.grad, 1e-8, 1e-12 * np.abs(want).max())
