"""Mean ``segmentation`` a scan on the graph solve: seeds, the sweeps
(hops, merges and the global merge's row-S sums), the finish (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "segmentation")
