"""Mean ``PipelineOutput.host_syncs`` a scan: the solve's device → host
reads (count)."""

from benchmark.harness.readers import counter


def read(record):
    return counter(record, lambda r: r.get("host_syncs"))
