"""Device ms a traced call of the program's ``analysis`` stages
(``MelCepstralVocoder.analyze``: the front end and the mel-cepstral
analysis), from the CUDA events that the program records around each
while the profiler records (``diffsptk_tpu_torch.utils.profiling``):
their sum over the traced window, every attempt of it, over the calls
of those attempts.  None where the program recorded none: a program
without the stages, or a run off the card."""

import sys

PROFILING = "diffsptk_tpu_torch.utils.profiling"


def stage_ms_per_call(run, names):
    """Device ms a traced call of the program's stages ``names``, as
    this process recorded them (rank 0's on several cards; a run's
    traced window is the only time its profiler records), or None."""
    reader = getattr(sys.modules.get(PROFILING), "stage_ms", None)
    if reader is None or run.trace is None:
        return None
    found = reader()
    ms = [sum(found[name]) for name in names if name in found]
    if not ms:
        return None
    return sum(ms) / (run.trace.calls * run.trace.attempts)


def read(run):
    return stage_ms_per_call(run, ("analysis",))
