"""Device ms a traced call of the program's ``ShardedCQT`` and
``ShardedICQT`` stages on rank 0 (each rank records its own; the
metrics are read in rank 0's process): the sharded CQT and ICQT of the
rank's block, their halo exchanges included, from the CUDA events the
program records around each, as ``span_ms.analysis`` reads them."""

from harness.manifest import module


def read(run):
    spans = module("metrics", "span_ms.analysis", run.cell.bench)
    return spans.stage_ms_per_call(run, ("ShardedCQT", "ShardedICQT"))
