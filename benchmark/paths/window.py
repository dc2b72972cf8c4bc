"""The window path (``knn_method="window"``): the stats sweep's k-th
distances, normals and curvature over a window of the Morton order.

* :func:`capture` keeps what ``pipeline.knn_normals_window_stats`` gave
  (with the sorted positions it read);
* :func:`reference` is the plain reference of a scan, its stage 1 from
  :mod:`benchmark.reference.stage1`, written from the definition;
* :func:`compare_stage1` gives ``sort_mismatch``, ``kth_dist_gap``,
  ``normal_gap``, ``normal_gap_determined`` and ``curvature_gap``.
"""

from benchmark.harness.check import compare_stage1
from benchmark.harness.wraps import capture_stage1 as capture
from benchmark.reference.segment import segment_reference as reference

__all__ = ["capture", "compare_stage1", "reference"]
