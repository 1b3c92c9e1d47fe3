"""Device functions (kernels, copies, fills) a call in the traced
window, counted from the profiler's trace: what the host enqueues; on
several cards, the rank with the most."""


def read(run):
    found = [len(t.device) / t.calls for t in run.all_traces() if t.device]
    return max(found) if found else None
