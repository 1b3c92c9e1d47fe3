"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell with its
configuration and traffic.  Everything else is a file of its own under
``benchmark/``, found by name, so that a later change adds a cell, a
configuration or a metric as new files and entries and edits none:

* ``configs/<config>.json``: the program's settings and sizes, and the
  plain reference that checks it (``reference/<reference>.py``);
* ``traffic/<traffic>.json``: the requests (``request`` names
  ``entries/<request>.py``), their batch and length, the pool of inputs,
  and the signal (``signals/<signal>.py``) that makes them from the seed;
* ``cells/<workload>.json``: the limits of the comparison that decides
  ``correct``, and the traced run's settings;
* ``metrics/<metric>.py``: a ``read(run)`` for each metric, end to end
  or per layer, returning a number or None where it finds nothing to
  read;
* ``work/<op>.py``: operations and bytes from shapes, for the rooflines.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str, bench: str = BENCH):
    """The module ``<bench>/<kind>/<name>.py``, loaded by its path (names
    may hold dots)."""
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict
    manifest: dict
    bench: str

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones untraced,
        its per-layer ones traced."""
        group = self.manifest["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]


def find(root: str, workload: str, bench: str = BENCH) -> Cell:
    """The cell named ``workload`` in ``<root>/BENCHMARK.json``."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic=load_json(os.path.join(bench, "traffic",
                                       f"{w['traffic']}.json")),
        spec=load_json(os.path.join(bench, "cells", f"{workload}.json")),
        manifest=manifest, bench=bench)
