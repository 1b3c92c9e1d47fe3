"""Run one cell of the benchmark of ``diffsptk_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It measures on the card and only there:
without CUDA, or with fewer cards than the cell asks for, it exits 3 and
prints no result.  It prints, as the last line of its standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones
with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number compared beside its limit; those numbers
are also its last lines on standard error.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PORT = "diffsptk_tpu_torch"


def fail(code: int, message: str) -> None:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail(2, "--seed must be a non-negative whole number")

    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    from harness import manifest, runner

    root = os.getcwd()
    cell = manifest.find(root, args.workload)

    import torch

    if not torch.cuda.is_available():
        fail(3, "no CUDA device: the benchmark measures on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"the cell asks for {cell.chips} cards and "
                f"{torch.cuda.device_count()} are visible")
    try:
        port = __import__(PORT)
    except ImportError as exc:
        fail(2, f"the program ({PORT}) is not in this checkout: {exc}")
    here = os.path.realpath(os.path.dirname(os.path.dirname(port.__file__)))
    if here != os.path.realpath(ROOT):
        fail(2, f"{PORT} was imported from {here}, not from this checkout")

    torch.set_num_threads(1)
    try:
        if cell.chips > 1:
            from harness import ranks

            result = ranks.spawn(root, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda",
                                 T_START)
        else:
            result = runner.run(root, args.workload, args.seed,
                                args.seconds, bool(args.trace),
                                torch.device("cuda", 0), T_START)
        found = runner.forbidden_modules()
        if found:
            raise runner.ForbiddenModules(found)
    except runner.ForbiddenModules as exc:
        fail(4, str(exc))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
