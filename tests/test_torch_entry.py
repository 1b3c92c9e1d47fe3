"""The port's entry points (diffsptk_tpu_torch/entry.py) against the JAX
repository's ``__graft_entry__.py`` on the CPU: ``entry()``'s forward
step, ``dryrun_multichip`` on two gloo ranks against the JAX dryrun's
line on two virtual devices, and its refusals (no card without
``device="cpu"``, more ranks than cards or CPU cores)."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffsptk_tpu_torch.entry import dryrun_multichip, entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"dryrun_multichip: mesh=\((\d+)x(\d+)\) flagship "
                  r"400/80/512 cep24 loss=([0-9.]+) paths=\[(.*)\] OK")


def test_entry_forward_matches_jax():
    """``entry(device="cpu")``: the flagship round trip of its example
    input (8 x 1,600 samples of 1e-3), float32, within 1e-3 of max|y| of
    the JAX entry's (which runs it in float64 here; 3.4e-4 apart)."""
    import jax

    import __graft_entry__
    fn, (x,) = entry(device="cpu")
    assert x.device.type == "cpu" and x.shape == (8, 1600)
    y = fn(x)
    jfn, (jx,) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jx))
    assert y.shape == want.shape and torch.isfinite(y).all()
    err = np.abs(y.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-3, err


def test_dryrun_multichip_on_gloo_ranks_matches_jax(capfd):
    """Two gloo ranks on the dryrun's (1, 2) mesh print the JAX dryrun's
    line, with its loss to the printed digits.  The JAX dryrun runs as its
    own command does, in a process of its own: with x64 on (this suite's
    setting) the JAX package's sharded WORLD returns zeros for the
    dryrun's float32 input, and its loss moves by that term (ROADMAP
    C.24)."""
    loss = dryrun_multichip(2, device="cpu")
    got = LINE.search(capfd.readouterr().out)
    run = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(2)"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    want = LINE.search(run.stdout)
    assert got and want, run.stderr[-2000:]
    assert got.group(1, 2) == want.group(1, 2) == ("1", "2")
    assert got.group(4) == want.group(4)
    assert abs(float(got.group(3)) - float(want.group(3))) <= 2e-6
    assert abs(loss - float(want.group(3))) <= 2e-6


def test_dryrun_multichip_refuses_without_the_cards():
    """With ``device=None`` the ranks are cards: none, or fewer than n,
    raises before a rank starts."""
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cards"):
            dryrun_multichip(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun_multichip(1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


@pytest.mark.parametrize("n", [0, (os.cpu_count() or 1) + 1],
                         ids=["none", "too-many"])
def test_dryrun_multichip_refuses_more_ranks_than_cores(n):
    """On the CPU one rank takes a core: 0 ranks, or more than the cores,
    raises before a rank starts."""
    with pytest.raises(RuntimeError, match="CPU cores"):
        dryrun_multichip(n, device="cpu")
