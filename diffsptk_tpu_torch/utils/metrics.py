"""Structured training observability (counterpart of
``diffsptk_tpu/utils/metrics.py``).

A JSONL event logger and the learner-callback adapter: every iterative
learner takes ``callback=`` and calls it once per iteration with plain
scalar metrics (and the current parameters); returning False stops the
loop.  With ``utils/checkpoint`` a stopped fit resumes where it stopped.
"""

from __future__ import annotations

import json
import time


class JsonlMetricsLogger:
    """Append one JSON object per event to ``path`` (or stdout)."""

    def __init__(self, path: str | None = None) -> None:
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, **kv) -> None:
        kv.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(kv, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line, flush=True)

    def as_callback(self):
        """A learner ``callback=`` that logs each iteration's scalars."""

        def cb(**kv):
            kv.pop("params", None)          # keep events scalar-only
            self.log(**kv)
            return True

        return cb

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def every(n: int, fn):
    """Callback combinator: run ``fn(iteration)`` every n-th iteration."""

    def cb(iteration, **kv):
        if iteration % n == 0:
            fn(iteration)
        return True

    return cb
