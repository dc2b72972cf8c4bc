"""Mean of ``read_ply`` + ``write_ply`` a scan (host I/O, ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "read_ply", "write_ply")
