"""Mean Σ ``seg.sync`` a scan: the solve's host time inside its device →
host reads, one span a read that ``host_syncs`` counts (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "seg.sync")
