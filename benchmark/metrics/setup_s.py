"""From the start of the process (the benchmark's first line) to the
start of the window: imports, the CUDA context, loading or building the
kernel libraries, the inputs made from the seed, and the warm calls."""


def read(run):
    return run.setup_s
