"""Mean ``render`` a scan: the writer thread's raster dispatch, fetch and
PNG encoding (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "render")
