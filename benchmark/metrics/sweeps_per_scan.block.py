"""Mean sweeps of the multigrid solve's coarse level a scan
(``PipelineOutput.num_sweeps``, each a host-driven launch and read;
count)."""

from benchmark.harness.readers import counter


def read(record):
    return counter(record, lambda r: r.get("num_sweeps"))
