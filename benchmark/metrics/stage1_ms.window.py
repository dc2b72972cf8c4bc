"""Mean ``stage1`` a scan on the window path: shift, Morton sort, stats
sweep, normals (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "stage1")
