"""Mean ``segmentation`` a scan on the multigrid window solve (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "segmentation")
