"""Input samples of every call completed in the window over the window's
wall time, from its start to the last call's end (host clock)."""


def read(run):
    if run.trace is not None or run.window_s <= 0:
        return None
    return run.calls * run.samples_per_call / run.window_s
