"""1 − (union of the card's kernel, copy and fill intervals) / traced
span, over the whole scans traced after the window, on the traced card,
in %."""

from benchmark.harness.trace import idle_pct


def read(record):
    return idle_pct(record.get("profile"))
