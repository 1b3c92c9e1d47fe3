"""torch.cuda.max_memory_allocated() over the window, from its start to
its close, in GiB; on several cards, the fullest."""


def read(run):
    if run.window_peak_bytes <= 0:
        return None
    return run.window_peak_bytes / 2**30
