"""Mean ``diagnostics["finalize_rows"]`` a scan: L, the side of the
outermost finalize's [L, L] coplanar pair test (count; none where the
rows carry no such counter)."""

from benchmark.harness.readers import counter


def read(record):
    return counter(record, lambda r: r.get("diagnostics", {}).get(
        "finalize_rows"))
