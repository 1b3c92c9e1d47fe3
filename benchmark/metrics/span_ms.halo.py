"""Device ms a traced call of the program's ``halo`` stages on rank 0
(each rank records its own; the metrics are read in rank 0's process):
the halo exchanges between neighbouring ranks, their buffers and their
wait on the neighbours included, and not the benchmark's closing
all-reduce between calls, from the CUDA events the program records
around each exchange, as ``span_ms.analysis`` reads them."""

from harness.manifest import module


def read(run):
    spans = module("metrics", "span_ms.analysis", run.cell.bench)
    return spans.stage_ms_per_call(run, ("halo",))
