"""Package rules of the port: it imports without JAX, names nothing of the
JAX package, defaults to the card, keeps fp32 matmuls inside its entry
points only, and plans the flagship cascade geometry as the JAX package
does."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
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
            "g = pt.MelGeneralizedCepstralAnalysis(fft_length=64,\n"
            "    cep_order=4, c=3, n_iter=2, device='cpu')(\n"
            "    torch.rand(2, 33) + 0.1)\n"
            "w = pt.LinearPredictiveCoefficientsToLineSpectralPairs(\n"
            "    4, device='cpu')(a)\n"
            "assert g.shape == (2, 5) and w.shape == (2, 5)\n"
            "sp = torch.rand(2, 257) + 0.1\n"
            "m = pt.MFCC(fft_length=512, mfcc_order=12, n_channel=20,\n"
            "    sample_rate=16000, device='cpu')(sp)\n"
            "p = pt.PLP(fft_length=512, plp_order=24, n_channel=40,\n"
            "    sample_rate=16000, device='cpu')(sp)\n"
            "s = pt.GammatoneFilterBankAnalysis(16000, device='cpu')(\n"
            "    torch.randn(2, 400))\n"
            "assert m.shape == (2, 12) and p.shape == (2, 24)\n"
            "assert s.shape == (2, 30, 400) and s.is_complex()\n"
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


def test_build_runs_every_nvcc_at_once_and_times_each(tmp_path, monkeypatch):
    """build() starts one compiler per source together, keeps each one's
    output and wall time, and installs each library when it finishes; a
    stand-in compiler that sleeps takes the place of nvcc."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=''; prev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "case \"$out\" in *libgather*) sleep 1;; esac\n"
        "echo \"ptxas info    : Used 7 registers\"\n"
        ": > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_logs", {})
    monkeypatch.setattr(build, "seconds", {})
    logs = build.build(("newton", "gather"))
    assert set(logs) == {"newton", "gather"}
    assert all("Used 7 registers" in log for log in logs.values())
    assert build.seconds["newton"] < 1.0 <= build.seconds["gather"]
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(build._paths(n)[1]) for n in ("newton", "gather"))
    took = dict(build.seconds)
    assert build.build(("newton",)) == {"newton": logs["newton"]}
    assert build.seconds == took               # nothing was compiled again


PARALLEL_NAMES = ("exchange_halo", "make_mesh", "ShardedSTFT", "sharded_frame",
                  "ShardedAllPoleDigitalFilter", "ShardedMelCepstralVocoder",
                  "ShardedWorldVocoder", "DataParallelGMM", "shard",
                  "unshard")


def test_parallel_imports_with_jax_blocked():
    """``diffsptk_tpu_torch.parallel`` imports without JAX, exports the
    JAX package's eight ``parallel`` names and ``shard`` / ``unshard``, and
    is not imported by the package itself (as the JAX package's is
    not); so do the training step ``parallel.train`` and the entry points
    ``diffsptk_tpu_torch.entry``, and none of them loads ``jax``."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            "import diffsptk_tpu_torch\n"
            "assert 'diffsptk_tpu_torch.parallel' not in sys.modules\n"
            "import diffsptk_tpu_torch.parallel as par\n"
            f"names = {PARALLEL_NAMES!r}\n"
            "missing = [n for n in names if not hasattr(par, n)]\n"
            "assert not missing, missing\n"
            "import diffsptk_tpu_torch.entry as entry\n"
            "import diffsptk_tpu_torch.parallel.train as train\n"
            "assert callable(entry.dryrun_multichip)\n"
            "assert callable(train.DryrunStep)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in\n"
            "            ('jax', 'diffsptk_tpu') and sys.modules[m]]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_parallel_sources_name_no_jax():
    """No identifier, attribute or import under parallel/ or in
    ``entry.py`` names ``jax`` or ``diffsptk_tpu`` (their docstrings cite
    the JAX package's files)."""
    bad = []
    pdir = os.path.join(PKG, "parallel")
    paths = [os.path.join(pdir, f) for f in sorted(os.listdir(pdir))
             if f.endswith(".py")] + [os.path.join(PKG, "entry.py")]
    for path in paths:
        f = os.path.relpath(path, PKG)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                names = [node.id]
            elif isinstance(node, ast.Attribute):
                names = [node.attr]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f}:{node.lineno}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_make_mesh_asks_for_the_card():
    """Without ``device_type`` the mesh is a CUDA one: with no card it
    raises as every operator does; with one it needs a process group."""
    from diffsptk_tpu_torch.parallel import make_mesh
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh((1, 1))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((1, 1))


SUBPACKAGES = ("models", "kernels", "utils")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackages_export_the_jax_names(sub):
    """Every public name of the JAX package's ``models``, ``kernels`` and
    ``utils`` is the port's counterpart's too, of the same kind (as
    ``tests/test_torch_functional.py::test_all_shared_names`` holds the
    top level), and so are the submodules they import by name."""
    import importlib
    import inspect
    import types

    jmod = importlib.import_module(f"diffsptk_tpu.{sub}")
    pmod = importlib.import_module(f"diffsptk_tpu_torch.{sub}")

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    names = {n for n in public(jmod)
             if not isinstance(getattr(jmod, n), types.ModuleType)}
    assert names, sub
    missing = sorted(names - public(pmod))
    assert not missing, missing
    differ = [n for n in sorted(names)
              if inspect.isclass(getattr(jmod, n))
              != inspect.isclass(getattr(pmod, n))
              or callable(getattr(jmod, n)) != callable(getattr(pmod, n))]
    assert not differ, differ
    with open(jmod.__file__) as f:
        tree = ast.parse(f.read())
    imported = [a.asname or a.name for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module is None
                for a in node.names]
    assert all(isinstance(getattr(pmod, n, None), types.ModuleType)
               for n in imported), imported


def test_subpackage_imports_build_nothing_with_jax_blocked():
    """``from diffsptk_tpu_torch.models import ...`` and ``.kernels import
    ...`` work without JAX, and importing them builds no CUDA source."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            "from diffsptk_tpu_torch.models import (MelCepstralVocoder,\n"
            "    WorldVocoder)\n"
            "from diffsptk_tpu_torch.kernels import (first_order_recurrence,\n"
            "    lfilter, sample_wise_lpc)\n"
            "from diffsptk_tpu_torch.utils import cas\n"
            "from diffsptk_tpu_torch.kernels import build\n"
            "assert not build._libs and not build._logs\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


TRAINERS = ("tools/torch_train_fcnf0.py", "tools/torch_train_crepe_tiny.py",
            "examples/torch_train_learnable_window.py")


def _load_script(path: str):
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trainers_import_with_jax_blocked():
    code = ("import importlib.util, os, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['diffsptk_tpu'] = None\n"
            f"for path in {TRAINERS!r}:\n"
            "    name = os.path.splitext(os.path.basename(path))[0]\n"
            "    spec = importlib.util.spec_from_file_location(name, path)\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    assert callable(mod.main)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_trainer_sources_import_no_jax():
    bad = []
    for path in TRAINERS:
        with open(os.path.join(ROOT, path)) as f:
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


@pytest.mark.parametrize("path", TRAINERS)
def test_trainers_take_the_card_unless_told(path):
    """Without ``--device`` a trainer asks for the card: with none it
    raises before it trains; ``--device cpu`` runs on the CPU."""
    from diffsptk_tpu_torch.core import resolve_device

    mod = _load_script(path)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--steps", "1"])


def test_learnable_window_example_trains_on_the_cpu(capsys):
    mod = _load_script(TRAINERS[2])
    losses = mod.main(["--device", "cpu", "--steps", "20", "--length",
                       "3200"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0]
    assert "correlation" in capsys.readouterr().out
