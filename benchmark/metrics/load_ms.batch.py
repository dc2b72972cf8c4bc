"""Mean ``host_to_device`` a scan of the multi-scan entry: the reader
thread's read, dedup, bucket and upload (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "host_to_device")
