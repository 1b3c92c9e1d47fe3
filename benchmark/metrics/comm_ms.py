"""Device time of the NCCL functions (the halo exchanges and the calls'
closing all-reduce) a call in the traced window, the union of their
intervals, on the rank where it is largest, in ms."""


def read(run):
    found = [t.union_us("nccl") / 1e3 / t.calls for t in run.all_traces()
             if t.device]
    return max(found) if found and max(found) > 0 else None
