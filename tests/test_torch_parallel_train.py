"""The JAX package's multi-chip training step on the port
(parallel/train.py, ``DryrunStep``) on eight CPU ``gloo`` ranks, at the
shapes of ``dryrun_multichip(8)`` (mesh (4, 2), B = 4, T = 4,800), in
float64, against the same step built here from the JAX package's sharded
classes on the eight virtual CPU devices of tests/conftest.py (the
definitions of ``__graft_entry__.py``'s ``dryrun_multichip``, jitted once
for the module), and against the port's one-rank (1, 1) step
(tests/test_torch_parallel.py describes the ranks).

Two parameter sets: the dryrun's own (its LPC coefficients [1, 0, ...]
make the all-pole filter the identity, so lpc's gradient is zero on both
sides) and the same with ``chip_smoke.stable_lpc``'s coefficients, which
give lpc a gradient through the blocked recurrence.  Bars: each loss term
rtol 1e-8 (WORLD's 1e-4, as tests/test_torch_parallel_world.py holds the
sharded WORLD), atol 1e-10 of mean(x^2); gradients and new parameters
rtol 1e-8, atol 1e-10 of max|g|.  Every rank's window after the step
equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import stable_lpc
from tests.test_torch_parallel import Pools, close, jax_mesh

THIS = __name__
LEAVES = ("window", "mc", "lpc")
KINDS = ("dryrun", "stable-lpc")
TERM_RTOL = {"world": 1e-4}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = Pools(tmp_path_factory, THIS)
    yield pools
    pools.close()


def dryrun_case():
    from diffsptk_tpu_torch.parallel.train import dryrun_inputs, dryrun_shape
    dp, tp, B, T = dryrun_shape(8)
    return (dp, tp), dryrun_inputs(B, T)


def leaf(tree: dict, name: str):
    return tree["window"]["window"] if name == "window" else tree[name]


# ------------------------------------------------------------- the ranks
def case_step(ctx, params, inputs, mesh_shape):
    """One ``train_step`` on the mesh from the JAX params pytree: the
    loss, each term summed over the ranks, the gradients and the new
    parameters gathered whole, and whether every rank holds the same new
    window."""
    from diffsptk_tpu_torch.parallel import unshard
    from diffsptk_tpu_torch.parallel.mesh import Axis, all_gather, mesh_sum
    from diffsptk_tpu_torch.parallel.train import DryrunStep
    mesh = ctx.mesh(mesh_shape)
    if mesh.get_coordinate() is None:
        return None
    step = DryrunStep(mesh, device="cpu", dtype=torch.float64)
    p = step.params_from_jax(params)
    x, target = step.blocks(inputs)
    with torch.no_grad():
        _, terms = step.loss(p, x, target)
    loss, new = step.train_step(p, x, target)

    def whole(t):
        return unshard(t.detach(), mesh, time_dim=-2).numpy()

    win = new["window"]["window"].detach()
    every = all_gather(all_gather(win, Axis(mesh, "tp")), Axis(mesh, "dp"))
    return {"loss": float(loss), "window_init": step.window_init(),
            "terms": {k: float(mesh_sum(v, mesh)) for k, v in terms.items()},
            "grads": {"window": p["window"]["window"].grad.numpy(),
                      "mc": whole(p["mc"].grad), "lpc": whole(p["lpc"].grad)},
            "new": {"window": win.numpy(), "mc": whole(new["mc"]),
                    "lpc": whole(new["lpc"])},
            "windows_equal": all(torch.equal(w, win)
                                 for w in every.reshape(-1, win.shape[-1]))}


def case_reduce(ctx, mesh_shape, names):
    """Each rank's gradients of two replicated parameters (rank-dependent
    values; a third without one), summed by ``reduce_replicated_grads``:
    every rank's results, gathered over the mesh."""
    from diffsptk_tpu_torch.parallel.mesh import (Axis, all_gather,
                                                  reduce_replicated_grads)
    mesh = ctx.mesh(mesh_shape, names)
    if mesh.get_coordinate() is None:
        return None
    a = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    b = torch.zeros(2, 2, dtype=torch.float64, requires_grad=True)
    c = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    (a * (ctx.rank + torch.arange(3.0))).sum().backward()
    (b * ctx.rank ** 2).sum().backward()
    reduce_replicated_grads([a, b, c], mesh)
    both = torch.cat([a.grad, b.grad.reshape(-1)])
    for name in reversed(names):
        both = all_gather(both, Axis(mesh, name))
    return both.reshape(-1, 7).numpy(), c.grad


@pytest.mark.parametrize("mesh_shape,names", [
    ((4, 2), ("dp", "tp")), ((2, 4), ("dp", "tp")), ((8,), ("tp",))])
def test_reduce_replicated_grads_sums_every_rank(ranks, mesh_shape, names):
    """The gradients come back as their sum over every rank of the mesh,
    the same bits on every rank, in place; a parameter without a gradient
    keeps none."""
    got, c_grad = ranks("case_reduce", mesh_shape=mesh_shape, names=names)
    r = np.arange(8.0)
    want = np.concatenate([r.sum() + 8 * np.arange(3.0),
                           np.full(4, (r ** 2).sum())])
    assert got.shape == (8, 7) and c_grad is None
    assert (got == want).all()


# ------------------------------------------------------------- the JAX step
@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's step on the (4, 2) mesh from both parameter sets:
    kind -> (params pytree, loss, terms, grads, new params), numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from diffsptk_tpu.parallel import ShardedSTFT
    from diffsptk_tpu.parallel.filterbanks import (
        ShardedIMDCT,
        ShardedIPQMF,
        ShardedMDCT,
        ShardedPQMF,
    )
    from diffsptk_tpu.parallel.filters import ShardedAllPoleDigitalFilter
    from diffsptk_tpu.parallel.vocoder import ShardedMelCepstralVocoder
    from diffsptk_tpu.parallel.world import ShardedWorldVocoder

    shape, inputs = dryrun_case()
    mesh = jax_mesh(*shape)
    FL, FP, FFT, M = 400, 80, 512, 24
    sstft = ShardedSTFT(mesh, frame_length=FL, frame_period=FP,
                        fft_length=FFT, learnable=["window"], eps=1e-6)
    voc = ShardedMelCepstralVocoder(
        mesh, frame_length=FL, frame_period=FP, fft_length=FFT,
        cep_order=M, n_iter=10)
    world = ShardedWorldVocoder(mesh, FP, 16000, 1024)
    apf = ShardedAllPoleDigitalFilter(mesh, M, FP)
    voc_bulk = ShardedMelCepstralVocoder(
        mesh, frame_length=FL, frame_period=FP, fft_length=FFT,
        cep_order=M, n_iter=10, taylor_order=6, cep_order_mlsa=99)
    smdct, simdct = ShardedMDCT(mesh, 240), ShardedIMDCT(mesh, 240)
    spqmf, sipqmf = ShardedPQMF(mesh, 4, 47), ShardedIPQMF(mesh, 4, 47)

    def loss_fn(p, x, target):
        terms = {
            "spec": jnp.mean((sstft(x, window_params=p["window"])
                              - target) ** 2),
            "voc": jnp.mean((voc.synthesize(x, p["mc"]) - x) ** 2),
            "world": jnp.mean(world.analysis_synthesis(x) ** 2),
            "apf": jnp.mean((apf(x, p["lpc"]) - x) ** 2),
            "bulk": jnp.mean((voc_bulk.synthesize(x, p["mc"], halo="bulk")
                              - x) ** 2),
            "mdct": jnp.mean((simdct(smdct(x), out_length=x.shape[-1])
                              - x) ** 2),
            "pqmf": jnp.mean((sipqmf(spqmf(x))[..., 0, :] - x) ** 2)}
        return sum(terms.values()), terms

    @jax.jit
    def train_step(p, x, target):
        (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, x, target)
        new_p = jax.tree.map(lambda a, g: a - 1e-3 * g, p, grads)
        return loss, terms, grads, new_p

    frames = NamedSharding(mesh, P("dp", "tp", None))
    x = jax.device_put(inputs["x"], NamedSharding(mesh, P("dp", "tp")))
    target = jax.device_put(inputs["target"], frames)
    window = {k: np.asarray(v)
              for k, v in sstft.op.window.trainable_params.items()}
    out = {}
    for kind in KINDS:
        lpc = (inputs["lpc"] if kind == "dryrun"
               else stable_lpc(*inputs["lpc"].shape[:2]))
        params = {"window": window, "mc": inputs["mc"], "lpc": lpc}
        loss, terms, grads, new = jax.tree.map(np.asarray, train_step(
            {"window": window, "mc": jax.device_put(params["mc"], frames),
             "lpc": jax.device_put(lpc, frames)}, x, target))
        out[kind] = (params, float(loss), {k: float(v) for k, v in
                                           terms.items()}, grads, new)
    return out


@pytest.fixture(scope="module")
def port_steps(ranks, jax_steps):
    """The port's step from the same params pytrees: kind -> (the (4, 2)
    mesh's result, the one-rank (1, 1) result)."""
    shape, inputs = dryrun_case()
    return {kind: tuple(ranks("case_step", params=jax_steps[kind][0],
                              inputs=inputs, mesh_shape=s)
                        for s in (shape, (1, 1)))
            for kind in KINDS}


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("kind", KINDS)
def test_step_loss_terms_match_jax(port_steps, jax_steps, kind):
    """Each of the seven terms, summed over the ranks' shares, and the
    loss summed over the ranks equal the JAX step's global means."""
    _, loss, terms, _, _ = jax_steps[kind]
    got = port_steps[kind][0]
    scale = float(np.mean(dryrun_case()[1]["x"] ** 2))
    assert set(got["terms"]) == set(terms)
    for name, want in terms.items():
        close(got["terms"][name], want, TERM_RTOL.get(name, 1e-8),
              1e-10 * scale)
    close(got["loss"], loss, 1e-8, 1e-10 * scale)


@pytest.mark.parametrize("kind", KINDS)
def test_step_grads_match_jax(port_steps, jax_steps, kind):
    """The gradients of the window (summed over every mesh axis), of mc
    (through the per-stage and the bulk halo) and of lpc (through the
    cross-rank summaries of the blocked recurrence) equal jax.grad's."""
    _, _, _, grads, _ = jax_steps[kind]
    got = port_steps[kind][0]["grads"]
    for name in LEAVES:
        want = leaf(grads, name)
        close(got[name], want, 1e-8, 1e-10 * np.abs(want).max())
    assert np.abs(got["window"]).max() > 0 and np.abs(got["mc"]).max() > 0
    lpc_moves = np.abs(got["lpc"]).max() > 0
    assert lpc_moves == (kind != "dryrun")


@pytest.mark.parametrize("kind", KINDS)
def test_step_new_params_match_jax(port_steps, jax_steps, kind):
    """The parameters after the SGD step equal the JAX step's."""
    _, _, _, grads, new = jax_steps[kind]
    got = port_steps[kind][0]["new"]
    for name in LEAVES:
        close(got[name], leaf(new, name), 1e-8,
              1e-10 * np.abs(leaf(grads, name)).max())


@pytest.mark.parametrize("kind", KINDS)
def test_step_matches_one_rank(port_steps, kind):
    """The eight-rank step equals the port's one-rank (1, 1) step: its
    loss, gradients and new parameters."""
    mesh8, one = port_steps[kind]
    close(mesh8["loss"], one["loss"], 1e-8, 0)
    for name in LEAVES:
        g = one["grads"][name]
        close(mesh8["grads"][name], g, 1e-8, 1e-10 * np.abs(g).max())
        close(mesh8["new"][name], one["new"][name], 1e-8,
              1e-10 * np.abs(g).max())


@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_holds_the_same_window(port_steps, kind):
    """After the step every rank's window is the same, bit for bit: the
    window's gradient is the sum over every rank on each of them."""
    assert port_steps[kind][0]["windows_equal"]
    assert port_steps[kind][1]["windows_equal"]


def test_window_carried_from_jax_is_the_ports(port_steps, jax_steps):
    """The JAX op's initial window equals the port's own
    (``DryrunStep.window_init``, where ``dryrun_multichip`` starts)."""
    close(port_steps["dryrun"][0]["window_init"],
          jax_steps["dryrun"][0]["window"]["window"], 1e-12, 0)
