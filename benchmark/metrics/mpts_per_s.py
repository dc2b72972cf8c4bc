"""Points of every scan completed in the window, over the window's time
from its start to the last completion (Mpts/s)."""

from benchmark.harness.arith import rate_per_s
from benchmark.harness.readers import rows


def read(record):
    r = rows(record)
    rate = rate_per_s([x["points"] for x in r], record["window"]["start"],
                      [x["end"] for x in r])
    return None if rate is None else rate / 1e6
