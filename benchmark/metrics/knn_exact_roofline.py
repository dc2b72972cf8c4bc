"""Kernel #14's share of its roofline (``csrc/knn_exact.cu``): least
time by ``roofline/knn_exact.py``'s count over its device time, %."""

from benchmark.harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "knn_exact")
