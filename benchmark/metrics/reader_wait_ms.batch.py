"""Mean ``wait.reader`` a scan of the multi-scan entry: the main thread,
which issues all device work, waiting on the reader thread's load (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "wait.reader")
