"""Mean sweeps of the graph solve a scan (``PipelineOutput.num_sweeps``;
count)."""

from benchmark.harness.readers import counter


def read(record):
    return counter(record, lambda r: r.get("num_sweeps"))
