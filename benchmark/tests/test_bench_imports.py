"""No module of the benchmark imports JAX or the JAX package, comparing
the top-level name whole, and the reference imports nothing of the
program; a run loads none of them."""

import ast
import os
import subprocess
import sys

from harness import manifest, runner

JAX = {"jax", "jaxlib", "flax", "diffsptk_tpu"}
PORT = "diffsptk_tpu_torch"


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub: str = ""):
    for base, _, files in os.walk(os.path.join(manifest.BENCH, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: imported(p) & JAX for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not imported(path) & {PORT, *JAX}, path
        assert imported(path) <= {"__future__", "math", "numpy", "torch"}


def test_a_run_loads_no_jax(checkout):
    code = ("import sys, time, torch\n"
            f"sys.path[:0] = [{manifest.BENCH!r}, {checkout!r}]\n"
            "from harness import runner\n"
            f"out = runner.run({checkout!r}, 'small.extract16', 3, 0.1, "
            f"False, torch.device('cpu'), time.perf_counter(), "
            f"bench={checkout + '/benchmark'!r})\n"
            "print(runner.forbidden_modules(), out['correct'])\n")
    env = dict(os.environ, PYTHONPATH="")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=checkout)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    monkeypatch.setitem(sys.modules, "diffsptk_tpu_torch_lookalike", sys)
    found = runner.forbidden_modules()
    assert "jaxtyping_lookalike" not in found
    assert "diffsptk_tpu_torch_lookalike" not in found
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in runner.forbidden_modules()
