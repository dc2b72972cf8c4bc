"""The port's profiling module on the CPU: ``trace`` writes a Chrome
trace holding the ``annotate`` spans the pipeline puts around its
stages (``stage1``, ``segmentation``, ``unsort``, ``device_to_host``,
``colorize`` on the window path; ``knn`` and ``normals`` on the
exact-kNN path).  ``tests/test_torch_spans.py`` holds the spans of every
host stage.
"""

import json
import os

import pytest

from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import segment_cloud
from buildingsegment_tpu_torch.profiling import TRACE_FILE, annotate, trace
from buildingsegment_tpu_torch.utils import make_building_cloud


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


@pytest.mark.parametrize("method,spans", [
    ("window", {"stage1", "segmentation", "unsort", "device_to_host",
                "colorize"}),
    ("brute", {"knn", "normals", "segmentation", "device_to_host",
               "colorize"}),
])
def test_trace_holds_pipeline_spans(tmp_path, method, spans):
    pts, _ = make_building_cloud(seed=2, spacing_mm=250.0, width_mm=4000.0,
                                 depth_mm=3000.0, wall_h_mm=2500.0,
                                 ridge_h_mm=3500.0)
    with trace(str(tmp_path), device="cpu"):
        with annotate("outer"):
            segment_cloud(HostPointCloud(positions=pts),
                          PipelineConfig(knn_method=method), device="cpu")
    path = os.path.join(tmp_path, TRACE_FILE)
    assert os.path.getsize(path) > 0
    names = _spans(path)
    assert spans | {"outer"} <= names, spans - names
