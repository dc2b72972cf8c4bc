"""Mean candidate tiles a query tile of #14 lists, the most it may
visit: ``diagnostics["knn_tiles_listed"]`` over
``diagnostics["knn_query_tiles"]`` of the sampled scans, as their
warm-up runs reported them (``paths/pallas.py``'s capture keeps each
run's diagnostics; the window's rows carry none) (count).  None where
the program reports no such counter."""

from benchmark.harness.arith import mean


def _ratio(scan):
    diag = (getattr(scan, "stage1", None) or {}).get("diagnostics", {})
    if diag.get("knn_query_tiles"):
        return diag["knn_tiles_listed"] / diag["knn_query_tiles"]
    return None


def read(record):
    got = record.get("compare", {}).get("got", {})
    return mean(v for v in map(_ratio, got.values()) if v is not None)
