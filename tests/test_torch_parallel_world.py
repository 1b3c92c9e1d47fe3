"""The port's sharded WORLD vocoder (parallel/world.py) on eight CPU
``gloo`` ranks against the JAX package's sharded WORLD vocoder on the same
mesh shapes, over the eight virtual CPU devices, in float64, and against
the port's one-rank WorldVocoder (tests/test_torch_parallel.py describes
the ranks).  The input is synthetic speech (chip_smoke.synth_speech),
never ``data.wav``; the tolerances are tests/test_parallel.py's: f0
1e-6, ap and sp 1e-4 / 1e-6, the waveform 1e-4 / 1e-6 of its largest
value.  Both packages key the synthesis noise by global pulse position
and batch row, so the streams agree."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import Pools, close, jax_mesh, speech, t64

THIS = __name__
T = 19200


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = Pools(tmp_path_factory, THIS)
    yield pools
    pools.close()


@pytest.fixture(scope="module")
def signal():
    return speech(2, T)


@pytest.fixture(scope="module")
def on_ranks(ranks, signal):
    """The ranks' results on each mesh shape, computed once."""
    seen = {}

    def run(mesh_shape):
        if mesh_shape not in seen:
            seen[mesh_shape] = ranks("case_world", x=signal,
                                     mesh_shape=mesh_shape)
        return seen[mesh_shape]
    return run


def case_world(ctx, x, mesh_shape):
    from diffsptk_tpu_torch.parallel import ShardedWorldVocoder, shard, unshard
    mesh = ctx.mesh(mesh_shape)
    voc = ShardedWorldVocoder(mesh, 80, 16000, 1024, device="cpu",
                              dtype=torch.float64)
    xb = shard(t64(x), mesh)
    f0, ap, sp = voc.analyze(xb)
    y = voc.synthesize(f0, ap, sp)
    y2 = voc.analysis_synthesis(xb)
    return (unshard(f0, mesh).numpy(), unshard(ap, mesh, time_dim=-2).numpy(),
            unshard(sp, mesh, time_dim=-2).numpy(), unshard(y, mesh).numpy(),
            unshard(y2, mesh).numpy())


def _jax_world(mesh_shape, x):
    import jax

    from diffsptk_tpu.parallel.world import ShardedWorldVocoder
    voc = ShardedWorldVocoder(jax_mesh(*mesh_shape), 80, 16000, 1024)
    f0, ap, sp = jax.jit(voc.analyze)(x)
    y = jax.jit(voc.synthesize)(f0, ap, sp)
    return [np.asarray(v) for v in (f0, ap, sp, y)]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_world_matches_jax(on_ranks, signal, mesh_shape):
    """Halo'd YIN / TANDEM / CheapTrick, the phase prefix and the
    overlap-add spills: N ranks equal the JAX package's sharded WORLD."""
    f0, ap, sp, y, y2 = on_ranks(mesh_shape)
    jf0, jap, jsp, jy = _jax_world(mesh_shape, signal)
    close(f0, jf0, 1e-6, 1e-8)
    close(ap, jap, 1e-4, 1e-6)
    close(sp, jsp, 1e-4, 1e-6)
    scale = float(np.abs(jy).max())
    close(y, jy, 1e-4, 1e-6 * scale)
    np.testing.assert_array_equal(y2, y)


def test_sharded_world_matches_one_rank(on_ranks, signal):
    """The (2, 4) ranks' analysis equals the port's one-rank WorldVocoder
    (even frames) at the same tolerances, and so does the synthesis of
    the same frames."""
    import diffsptk_tpu_torch as pt
    f0, ap, sp, y, _ = on_ranks((2, 4))
    single = pt.WorldVocoder(80, 16000, 1024, device="cpu",
                             dtype=torch.float64)
    rf0, rap, rsp = single.analyze(t64(signal), even_frames=True)
    close(f0, rf0, 1e-6, 1e-8)
    close(ap, rap, 1e-4, 1e-6)
    close(sp, rsp, 1e-4, 1e-6)
    ry = single.synthesize(t64(f0), t64(ap), t64(sp)).numpy()
    close(y, ry, 1e-4, 1e-6 * float(np.abs(ry).max()))
