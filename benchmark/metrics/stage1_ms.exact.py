"""Mean ``stage1`` a scan on the exact-kNN path: shift, Morton argsort,
#14's preparation and launch, the lists' scatter back to the input
order, the hybrid normals (ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "stage1")
