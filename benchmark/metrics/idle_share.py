"""The share of the traced window, on the host clock, in which no device
function ran, in %; on several cards, the rank where it is largest."""


def read(run):
    found = [100.0 * (1.0 - t.busy_s() / t.window_s)
             for t in run.all_traces() if t.device]
    return max(found) if found else None
