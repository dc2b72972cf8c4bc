"""90th percentile (nearest rank) over all scans completed in the window
of each scan's time: PLY read to PLY written, or arrays in to labels on
the host (ms)."""

from benchmark.harness.arith import nearest_rank
from benchmark.harness.readers import rows


def read(record):
    v = nearest_rank([x["latency_s"] for x in rows(record)], 0.9)
    return None if v is None else 1e3 * v
