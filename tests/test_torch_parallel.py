"""The port's sharded paths (diffsptk_tpu_torch/parallel/) on CPU ``gloo``
ranks against the JAX package's sharded classes on the same mesh shapes.

Eight ranks are spawned once for the module (``torch.multiprocessing``,
"spawn"; a ``FileStore`` under the test's temporary directory, so no TCP
port is shared; one thread each; ``init_process_group`` with a 60 s
timeout).  Every case runs in all of them: each rank builds the mesh (a
(dp, tp) ``DeviceMesh`` over ranks 0 .. dp*tp-1, cached by shape), cuts
the case's numpy input into its block with ``shard``, runs the port's
class on it and gathers the result back with ``unshard``; rank 0 returns
it as numpy.  A rank outside the mesh returns None.  The pool is joined
with a deadline, so a hang fails the test.

The references are the JAX package's sharded classes over the eight
virtual CPU devices that tests/conftest.py sets, in float64 (x64), on the
same numpy input; the port's unsharded classes are a second reference.
Inputs are synthetic (numpy noise and a synthetic voiced signal), never
``data.wav``.  Tolerances are those of tests/test_parallel.py case for
case; gradients are held to ``jax.grad`` / ``jax.vjp`` of the sharded
JAX classes.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import traceback

import numpy as np
import pytest
import torch

WORLD = 8
DEADLINE = 120.0        # seconds a case may take on all ranks together
THIS = __name__


# --------------------------------------------------------------- the ranks
class RankContext:
    """What a case function sees on its rank: the rank and its meshes."""

    def __init__(self, rank: int) -> None:
        self.rank = rank
        self._meshes: dict = {}

    def mesh(self, shape, axis_names=("dp", "tp")):
        """The CPU mesh of ``shape`` (built by every rank together the
        first time a shape is asked for)."""
        from diffsptk_tpu_torch.parallel import make_mesh
        key = (shape, tuple(axis_names))
        if key not in self._meshes:
            self._meshes[key] = make_mesh(shape, axis_names,
                                          device_type="cpu")
        return self._meshes[key]


def _rank_main(rank: int, store_path: str, tasks, results) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    ctx = RankContext(rank)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            module, name, kwargs = task
            try:
                fn = getattr(importlib.import_module(module), name)
                results.put((rank, True, fn(ctx, **kwargs)))
            except Exception:       # reported to the test, which fails
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """WORLD spawned gloo ranks that run case functions on request."""

    def __init__(self, tmpdir: str) -> None:
        mp = multiprocessing.get_context("spawn")
        self.results = mp.Queue()
        self.tasks = [mp.Queue() for _ in range(WORLD)]
        store = os.path.join(tmpdir, "store")
        self.procs = [mp.Process(target=_rank_main,
                                 args=(r, store, self.tasks[r],
                                       self.results), daemon=True)
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self.broken = False

    def run(self, module: str, name: str, **kwargs):
        """Run ``module.name(ctx, **kwargs)`` on every rank; return rank
        0's result.  A failure or a missed deadline on any rank fails the
        case and retires the pool."""
        for q in self.tasks:
            q.put((module, name, kwargs))
        out, errors = {}, []
        try:
            for _ in range(WORLD):
                rank, ok, value = self.results.get(timeout=DEADLINE)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            errors.append(f"ranks {sorted(set(range(WORLD)) - set(out))} "
                          f"missed the {DEADLINE} s deadline")
        if errors:
            self.broken = True
            raise AssertionError("\n".join(errors))
        return out[0]

    def close(self) -> None:
        """Ask every rank to leave; terminate those still inside a
        collective a broken case left them in."""
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=5 if self.broken else 30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)


class Pools:
    """A pool for the module, started again after a case breaks it."""

    def __init__(self, tmp_path_factory, module: str) -> None:
        self.factory = tmp_path_factory
        self.module = module
        self.pool = None

    def __call__(self, name: str, **kwargs):
        if self.pool is not None and self.pool.broken:
            self.pool.close()
            self.pool = None
        if self.pool is None:
            self.pool = RankPool(str(self.factory.mktemp("ranks")))
        return self.pool.run(self.module, name, **kwargs)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = Pools(tmp_path_factory, THIS)
    yield pools
    pools.close()


def t64(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------ JAX helpers
def jax_mesh(dp, tp):
    import jax
    from jax.sharding import Mesh
    if dp is None:
        return Mesh(np.array(jax.devices()[:tp]), ("tp",))
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("dp", "tp"))


def speech(B: int, T: int) -> np.ndarray:
    """Synthetic voiced speech, float64 (chip_smoke.synth_speech)."""
    from chip_smoke import synth_speech
    return synth_speech(B, T).astype(np.float64)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# --------------------------------------------------------- mesh and halo
def case_mesh(ctx):
    from diffsptk_tpu_torch.parallel import make_mesh
    from diffsptk_tpu_torch.parallel.mesh import axis_size
    m = ctx.mesh(4, ("tp",))
    m2 = ctx.mesh((2, 4))
    m3 = make_mesh(None, device_type="cpu")
    try:
        make_mesh((3, 3), device_type="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    return (tuple(m.mesh_dim_names), axis_size(m, "tp"),
            {n: axis_size(m2, n) for n in m2.mesh_dim_names},
            tuple(m3.shape), error)


def test_make_mesh(ranks):
    names, ntp, shape2, shape3, error = ranks("case_mesh")
    assert names == ("tp",) and ntp == 4
    assert shape2 == {"dp": 2, "tp": 4}
    assert shape3 == (4, 2)
    assert error == "mesh needs 9 devices, have 8"


HALO_MODES = ["constant", "edge", "reflect", ("constant", "edge")]


def case_halo(ctx, x, ct, mode, left, right):
    from diffsptk_tpu_torch.parallel import exchange_halo, shard, unshard
    from diffsptk_tpu_torch.parallel.mesh import Axis
    mesh = ctx.mesh((2, 4))
    xb = shard(t64(x), mesh).clone().requires_grad_(True)
    y = exchange_halo(xb, left, right, Axis(mesh, "tp"), pad_mode=mode)
    y.backward(shard(t64(ct), mesh))
    return (unshard(y.detach(), mesh).numpy(),
            unshard(xb.grad, mesh).numpy())


@pytest.mark.parametrize("mode", HALO_MODES,
                         ids=["constant", "edge", "reflect", "pair"])
def test_exchange_halo_and_its_backward(ranks, mode):
    """Forward against the JAX exchange in shard_map, backward against
    jax.vjp of it with the same cotangent."""
    import jax
    from jax.sharding import PartitionSpec as P

    from diffsptk_tpu.parallel import exchange_halo
    left, right = 5, 3
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 4 * 12))
    ct = rng.standard_normal((4, 4 * (12 + left + right)))
    jm = jax_mesh(2, 4)
    fn = jax.shard_map(
        lambda b: exchange_halo(b, left, right, "tp", pad_mode=mode),
        mesh=jm, in_specs=(P("dp", "tp"),), out_specs=P("dp", "tp"),
        check_vma=False)
    want, vjp = jax.vjp(jax.jit(fn), x)
    (want_g,) = vjp(ct)
    got, got_g = ranks("case_halo", x=x, ct=ct, mode=mode, left=left,
                       right=right)
    np.testing.assert_array_equal(got, np.asarray(want))
    close(got_g, want_g, 1e-12, 1e-14)


def case_halo_too_wide(ctx):
    from diffsptk_tpu_torch.parallel import exchange_halo
    from diffsptk_tpu_torch.parallel.mesh import Axis
    mesh = ctx.mesh((1, 8))
    try:
        exchange_halo(torch.zeros(2, 4), 5, 0, Axis(mesh, "tp"))
    except ValueError as e:
        return str(e)
    return None


def test_exchange_halo_refuses_a_halo_wider_than_the_block(ranks):
    assert "exceeds the local block length 4" in ranks("case_halo_too_wide")


# ------------------------------------------------------------ frame, STFT
def case_frame(ctx, x, ntp, center):
    from diffsptk_tpu_torch.parallel import shard, sharded_frame, unshard
    mesh = ctx.mesh(ntp, ("tp",))
    if mesh.get_coordinate() is None:
        return None
    y = sharded_frame(shard(t64(x), mesh, batch_dim=None), 50, 10, mesh,
                      batch_axis_name=None, center=center)
    return unshard(y, mesh, time_dim=-2, batch_dim=None).numpy()


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("ntp", [2, 4])
def test_sharded_frame_matches_jax(ranks, center, ntp):
    import jax

    import diffsptk_tpu
    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel import sharded_frame
    x = np.random.default_rng(0).standard_normal(1600)
    want = jax.jit(lambda v: sharded_frame(
        v, 50, 10, jax_mesh(None, ntp), batch_axis_name=None,
        center=center))(x)
    got = ranks("case_frame", x=x, ntp=ntp, center=center)
    close(got, want, 1e-12, 1e-14)
    close(got, diffsptk_tpu.Frame(50, 10, center=center)(x), 1e-12, 1e-14)
    close(got, pt.Frame(50, 10, center=center, device="cpu",
                        dtype=torch.float64)(t64(x)), 1e-12, 1e-14)


def case_stft(ctx, x, ntp, ct=None, kw=None):
    from diffsptk_tpu_torch.parallel import ShardedSTFT, shard, unshard
    mesh = ctx.mesh((2, ntp))
    if mesh.get_coordinate() is None:
        return None
    L, P, N = (100, 50, 128) if ct is not None else (400, 80, 512)
    op = ShardedSTFT(mesh, L, P, N, device="cpu", dtype=torch.float64,
                     **(kw or {}))
    xb = shard(t64(x), mesh).clone().requires_grad_(ct is not None)
    y = op(xb)
    out = unshard(y.detach(), mesh, time_dim=-2).numpy()
    if ct is None:
        return out
    y.backward(shard(t64(ct), mesh, time_dim=-2))
    return out, unshard(xb.grad, mesh).numpy()


@pytest.mark.parametrize("ntp", [2, 4])
def test_sharded_stft_matches_jax(ranks, ntp):
    import jax

    import diffsptk_tpu
    from diffsptk_tpu.parallel import ShardedSTFT
    x = np.random.default_rng(1).standard_normal((2, 1600))
    want = jax.jit(ShardedSTFT(jax_mesh(2, ntp), 400, 80, 512))(x)
    got = ranks("case_stft", x=x, ntp=ntp)
    close(got, want, 1e-10, 1e-12)
    close(got, diffsptk_tpu.STFT(400, 80, 512)(x), 1e-10, 1e-12)


def test_sharded_stft_grad_matches_jax(ranks):
    """The gradient of a weighted sum of the sharded STFT: jax.grad of the
    JAX package's sharded STFT, and the one-rank port's."""
    import jax
    import jax.numpy as jnp

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel import ShardedSTFT
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 800))
    w = rng.standard_normal((2, 16, 65))
    op = ShardedSTFT(jax_mesh(2, 2), 100, 50, 128, eps=1e-8)
    want = jax.jit(jax.grad(lambda v: jnp.sum(op(v) * w)))(x)
    _, got = ranks("case_stft", x=x, ntp=2, ct=w, kw=dict(eps=1e-8))
    close(got, want, 1e-10, 1e-12)
    xt = t64(x).requires_grad_(True)
    (pt.STFT(100, 50, 128, eps=1e-8, device="cpu", dtype=torch.float64)(xt)
     * t64(w)).sum().backward()
    close(got, xt.grad, 1e-10, 1e-12)


# ------------------------------------------------------ all-pole filter
def poledf_inputs(M=6, P=80, T=6400, B=2):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T))
    a = np.concatenate(
        [np.ones((B, T // P, 1)),
         0.2 * rng.standard_normal((B, T // P, M)) / np.arange(1, M + 1)],
        axis=-1)
    return x, a


def case_poledf(ctx, x, a, mesh_shape, M, P, ct):
    from diffsptk_tpu_torch.parallel import (ShardedAllPoleDigitalFilter,
                                             shard, unshard)
    mesh = ctx.mesh(mesh_shape)
    op = ShardedAllPoleDigitalFilter(mesh, M, P)
    xb = shard(t64(x), mesh).clone().requires_grad_(True)
    ab = shard(t64(a), mesh, time_dim=-2).clone().requires_grad_(True)
    y = op(xb, ab)
    y.backward(shard(t64(ct), mesh))
    return (unshard(y.detach(), mesh).numpy(), unshard(xb.grad, mesh).numpy(),
            unshard(ab.grad, mesh, time_dim=-2).numpy())


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_poledf_matches_jax(ranks, mesh_shape):
    """The cross-rank state handoff reproduces the JAX package's sharded
    filter and the port's one-rank AllPoleDigitalFilter at rtol 1e-8;
    the gradients of x and a (through the all-gathered summaries) equal
    jax.vjp of the JAX sharded filter."""
    import jax

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.filters import ShardedAllPoleDigitalFilter
    M, P = 6, 80
    x, a = poledf_inputs(M, P)
    ct = np.random.default_rng(1).standard_normal(x.shape)
    want, vjp = jax.vjp(jax.jit(ShardedAllPoleDigitalFilter(
        jax_mesh(*mesh_shape), M, P)), x, a)
    gx, ga = vjp(ct)
    got, got_gx, got_ga = ranks("case_poledf", x=x, a=a,
                                mesh_shape=mesh_shape, M=M, P=P, ct=ct)
    close(got, want, 1e-8, 1e-10)
    close(got_gx, gx, 1e-8, 1e-10)
    close(got_ga, ga, 1e-8, 1e-10 * np.abs(ga).max())
    single = pt.AllPoleDigitalFilter(M, P, device="cpu",
                                     dtype=torch.float64)
    close(got, single(t64(x), t64(a)), 1e-8, 1e-10)


def case_lpc_block(ctx):
    from diffsptk_tpu_torch.kernels.recurrence import sample_wise_lpc
    mesh = ctx.mesh((1, 8))
    try:
        sample_wise_lpc(torch.zeros(1, 100), torch.zeros(1, 100, 3),
                        block=64, axis_name=(mesh, "tp"))
    except ValueError as e:
        return str(e)
    return None


def test_sharded_lpc_needs_the_block_to_divide_the_local_length(ranks):
    assert "block | local T" in ranks("case_lpc_block")


# -------------------------------------------------------------------- GMM
def gmm_data():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(-2, 0.5, (64, 3)),
                           rng.normal(+2, 0.8, (64, 3))])


def case_gmm(ctx, x, warm):
    import numpy as np_

    from diffsptk_tpu_torch.parallel import DataParallelGMM
    mesh = ctx.mesh(8, ("dp",))
    gmm = DataParallelGMM(mesh, 2, 2, n_iter=10, seed=1, device="cpu",
                          dtype=torch.float64)
    rows = np_.array_split(x, 8)[ctx.rank]
    if warm:
        gmm.warmup(t64(rows))
    (w, mu, s), ll = gmm(t64(rows))
    try:
        gmm(t64(np_.array_split(x[:127], 8)[ctx.rank]))
        error = None
    except ValueError as e:
        error = str(e)
    return w.numpy(), mu.numpy(), s.numpy(), float(ll), error


@pytest.mark.parametrize("warm", [False, True], ids=["seed", "lbg-warm"])
def test_data_parallel_gmm_matches_jax(ranks, warm):
    """Eight ranks of 16 rows each equal the JAX package's DataParallelGMM
    and the port's one-rank GMM (rtol 1e-8, sigma 1e-7, ll 1e-6); with the
    LBG warm start too, whose sums are all-reduced as well.  Unequal row
    counts raise the "divisible" ValueError on every rank."""
    import jax
    from jax.sharding import Mesh

    import diffsptk_tpu_torch as pt
    from diffsptk_tpu.parallel.learners import DataParallelGMM
    x = gmm_data()
    w, mu, s, ll, error = ranks("case_gmm", x=x, warm=warm)
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("dp",))
    jg = DataParallelGMM(mesh, 2, 2, n_iter=10, seed=1)
    if warm:
        jg.warmup(x)
    (jw, jmu, js), jll = jg(x)
    single = pt.GMM(2, 2, n_iter=10, seed=1, device="cpu",
                    dtype=torch.float64)
    if warm:
        single.warmup(t64(x))
    (tw, tmu, ts), tll = single(t64(x))
    for ref_w, ref_mu, ref_s, ref_ll in ((jw, jmu, js, jll),
                                         (tw, tmu, ts, tll)):
        close(w, ref_w, 1e-8, 0)
        close(mu, ref_mu, 1e-8, 0)
        close(s, ref_s, 1e-7, 0)
        assert abs(ll - float(ref_ll)) < 1e-6
    assert error is not None and "divisible" in error
