"""Row S's share of its roofline (``csrc/segment_sum.cu`` with its sort,
``csrc/segment_sort.cu``): least time by ``roofline/segment_sums.py``'s
count over its device time, summed over every call of the traced scans,
%."""

from benchmark.harness.readers import roofline_pct


def read(record):
    return roofline_pct(record, "segment_sums")
