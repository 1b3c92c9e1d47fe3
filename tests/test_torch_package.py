"""Package rules of the port: it imports without JAX, names nothing of the
JAX package, defaults to the card, keeps fp32 matmuls inside its entry
points only, and plans the flagship cascade geometry as the JAX package
does."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

import diffsptk_tpu_torch as pt
from diffsptk_tpu_torch.core import full_precision
from diffsptk_tpu_torch.kernels import build
from diffsptk_tpu_torch.kernels.mlsa_cascade import (
    cascade_plan,
    chunked_geometry,
    lane_aligned_nfft,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "diffsptk_tpu_torch")


def _forbidden(name: str) -> bool:
    for root in ("jax", "diffsptk_tpu"):
        if name == root or name.startswith(root + "."):
            return True
    return False


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            "import diffsptk_tpu_torch as pt, torch\n"
            "v = pt.MelCepstralVocoder(device='cpu', cascade='fused')\n"
            "y = v.analysis_synthesis(torch.randn(1, 800))\n"
            "assert y.shape == (1, 800)\n"
            "a = pt.LPC(32, 4, device='cpu')(torch.randn(2, 32))\n"
            "y = pt.AllPoleDigitalFilter(4, 8, device='cpu')(\n"
            "    torch.randn(2, 8), a[:, None])\n"
            "assert y.shape == (2, 8)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_world_runs_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            "import diffsptk_tpu_torch as pt, torch\n"
            "w = pt.WorldVocoder(ap_algorithm='d4c', device='cpu')\n"
            "y = w.analysis_synthesis(torch.randn(1, 1600))\n"
            "assert y.shape == (1, 1600) and torch.isfinite(y).all()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_jax_import_in_sources():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_ops_default_to_the_card():
    if torch.cuda.is_available():
        assert pt.Window(8).window.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Window(8)
        with pytest.raises(RuntimeError):
            pt.MelCepstralVocoder()
    assert pt.Window(8, device="cpu").window.device.type == "cpu"


def test_full_precision_is_scoped():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    seen = []

    @full_precision
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    torch.backends.cudnn.allow_tf32 = True
    try:
        probe()
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_flagship_cascade_geometry():
    """P=80, M=199: the tap-chunked branch with Q=3, nfft 254."""
    nfft = lane_aligned_nfft(2 * 80 + 199 + 1)
    assert nfft == 510
    assert chunked_geometry(199, 80, nfft) == (3, 254)
    Ffwd, Gre, Gim, r0, n_blk = cascade_plan(254, 79, 80, 0)
    assert Ffwd.shape == (3, 80, 256) and Gre.shape == (128, 240)
    assert (r0, n_blk) == (2, 3)


def test_build_targets_hopper():
    cmd = build.command("nvcc", "a.cu", "a.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    for name in build.SOURCES:
        assert os.path.exists(os.path.join(build.CSRC, f"{name}.cu"))
