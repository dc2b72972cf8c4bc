"""Mean ``host_to_device`` a scan: host bbox shift, padded upload and
the proven hints (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "host_to_device")
