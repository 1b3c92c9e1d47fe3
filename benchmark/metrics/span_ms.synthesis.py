"""Device ms a traced call of the program's ``synthesis`` stages: in a
round trip (``MelCepstralVocoder.analysis_synthesis``) the inverse MLSA
filter, then the MLSA filter, from the CUDA events the program records
around each, as ``span_ms.analysis`` reads them."""

from harness.manifest import module


def read(run):
    spans = module("metrics", "span_ms.analysis", run.cell.bench)
    return spans.stage_ms_per_call(run, ("synthesis",))
