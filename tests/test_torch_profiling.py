"""The port's profiling module against the JAX package's, on the CPU.

``summarize`` prints the JAX package's JSON line bit for bit;
``StageTimer`` accumulates and rates as JAX's; ``trace`` writes a Chrome
trace holding the ``annotate`` spans the pipeline puts around its
stages (``stage1``, ``segmentation``, ``unsort``, ``device_to_host``,
``colorize`` on the window path; ``knn`` and ``normals`` on the
exact-kNN path).
"""

import json
import os

import numpy as np
import pytest
import torch

from buildingsegment_tpu.profiling import (
    StageTimer as JaxStageTimer,
    summarize as jax_summarize,
)
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import segment_cloud
from buildingsegment_tpu_torch.profiling import (
    TRACE_FILE,
    StageTimer,
    annotate,
    summarize,
    trace,
)
from buildingsegment_tpu_torch.utils import make_building_cloud


@pytest.mark.parametrize("timings,points", [
    ({"read": 0.123456789, "stage1": 1.0, "segmentation": 2.5e-5}, 222828),
    ({}, 0),
    ({"total": 3.3333333}, 1_082_304),
])
def test_summarize_matches_jax(timings, points):
    assert summarize(timings, points) == jax_summarize(timings, points)


def test_stage_timer_matches_jax():
    a, b = JaxStageTimer(), StageTimer()
    for timer in (a, b):
        for name in ("x", "y", "x"):
            with timer.stage(name):
                pass
    assert sorted(a.times) == sorted(b.times) == ["x", "y"]
    b.times = dict(a.times)
    assert b.mpoints_per_sec(10**6) == a.mpoints_per_sec(10**6)
    assert b.mpoints_per_sec(10**6, "y") == a.mpoints_per_sec(10**6, "y")


def test_stage_timer_blocks_on_tensors():
    timer = StageTimer()
    x = torch.ones(4)
    with timer.stage("a", block_on=(x, {"b": [x * 2]})):
        y = x + 1
    assert timer.times["a"] > 0 and float(y.sum()) == 8.0


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
