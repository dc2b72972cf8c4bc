"""Kernel #3's share of its roofline (``csrc/stats_sweep.cu``): least
time by ``roofline/stats_sweep.py``'s count over its device time, %."""

from benchmark.harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "stats_sweep")
