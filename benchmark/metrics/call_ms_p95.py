"""The 95th percentile of every window call's time, from its start to the
synchronise that ends it (host clock), in ms."""

from harness.runner import percentile


def read(run):
    if not run.call_s:
        return None
    return 1e3 * percentile(run.call_s, 95)
