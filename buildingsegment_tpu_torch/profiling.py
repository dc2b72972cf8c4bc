"""Tracing and stage timing of the port.

Port of ``buildingsegment_tpu/profiling.py`` on ``torch.profiler``:

  * :func:`trace` — a profiler trace (host ops, and the card's kernels
    when the device is the card) around any block, exported as a Chrome
    trace (view in Perfetto or chrome://tracing);
  * :func:`annotate` — a named span in that trace; the pipeline puts one
    around each stage it times (``stage1``, ``knn``, ``normals``,
    ``segmentation``, ``unsort``, ``device_to_host``, ``colorize``);
  * :class:`StageTimer` — wall time by stage, each stop after the
    device's queued work;
  * :func:`summarize` — the JSON summary line of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

from buildingsegment_tpu_torch.utils.device import synchronize

__all__ = ["trace", "annotate", "StageTimer", "summarize", "TRACE_FILE"]

#: the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda"):
    """Profile the block and write ``log_dir/trace.json``.  The card's
    kernels are recorded when ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named span in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _devices(obj):
    """The devices of the tensors in ``obj`` (nested tuples, lists and
    dicts)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device}
    if isinstance(obj, (tuple, list)):
        return set().union(*(_devices(x) for x in obj))
    if isinstance(obj, dict):
        return _devices(list(obj.values()))
    return set()


class StageTimer:
    """Wall-time accumulator keyed by stage name.  A stage given
    ``block_on`` (tensors) stops its clock after their devices' queued
    work, so asynchronous launches do not move card time into a later
    stage."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _devices(block_on):
                synchronize(dev)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def mpoints_per_sec(self, points: int, stage: Optional[str] = None) -> float:
        total = (
            self.times.get(stage, 0.0)
            if stage
            else sum(self.times.values())
        )
        return points / max(total, 1e-9) / 1e6


def summarize(timings: Dict[str, float], points: int) -> str:
    """One-line JSON summary for logs."""
    return json.dumps(
        {
            "points": points,
            "stages": {k: round(v, 4) for k, v in timings.items()},
            "mpoints_per_sec": round(
                points / max(sum(timings.values()), 1e-9) / 1e6, 3
            ),
        }
    )
