"""Mean Σ ``mg.finalize`` a scan: the multigrid levels' finalize —
payload sums, the coplanar merge (``mg.merge``), the hole adoption
(``mg.adopt``), the cull and dense table (``mg.cull``) — in host time
(ms)."""

from benchmark.harness.readers import timing_ms


def read(record):
    return timing_ms(record, "mg.finalize")
