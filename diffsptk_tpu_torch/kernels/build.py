"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use into ``diffsptk_tpu_torch/_build/`` (named by a hash of the
source, so an edited source is rebuilt) and needs nothing but the
sources of this package and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("newton", "mlsa_cascade", "mlsa_cascade_tc", "spd_solve", "scan",
           "gather", "ola", "threefry")

_libs: dict[tuple, ctypes.CDLL] = {}
_logs: dict = {}
seconds: dict = {}
"""Wall time of each target's nvcc in the last build that compiled it."""
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc was not found; the CUDA kernels cannot be built")


def _paths(name: str, defines=()) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(defines).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}-{digest.hexdigest()[:12]}.so")


def command(nvcc: str, src: str, out: str, defines=()) -> list[str]:
    """The nvcc command line that builds ``src`` into ``out``, with a
    ``-D`` for each of ``defines``."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *(f"-D{d}" for d in defines), "-o", out, src]


def build(targets=SOURCES) -> dict:
    """Compile every target that has no current library, all at once (one
    nvcc each), and return the compiler's output by target.  A target is
    a source name, or a (name, defines) pair for a variant of it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    nvcc = _nvcc()
    t0 = time.monotonic()
    for target in targets:
        name, defines = (target, ()) if isinstance(target, str) else target
        src, lib = _paths(name, defines)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")
        procs[target] = (subprocess.Popen(
            command(nvcc, src, tmp, defines), stdout=log,
            stderr=subprocess.STDOUT, text=True), tmp, lib, log)
    failed = []
    while procs:
        done = [t for t, (proc, *_) in procs.items()
                if proc.poll() is not None]
        if not done:
            time.sleep(0.05)
        for target in done:
            proc, tmp, lib, log = procs.pop(target)
            seconds[target] = time.monotonic() - t0
            log.seek(0)
            out = _logs[target] = log.read()
            log.close()
            os.remove(log.name)
            if proc.returncode != 0:
                failed.append(f"{target}:\n{out}")
                continue
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {t: _logs.get(t, "(library was current)") for t in targets}


def library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built at first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            _, path = _paths(*key)
            if not os.path.exists(path):
                build((key,))
            lib = ctypes.CDLL(path)
            _libs[key] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch(fn, what: str, device: torch.device, *args) -> None:
    """Call the C entry ``fn(*args)``, which enqueues a kernel, with
    ``device`` current (``torch.cuda.device`` is entered only when another
    device is), and raise on a non-zero ``cudaError_t``."""
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    check(err, what)
