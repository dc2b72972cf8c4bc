"""Tracing and stage timing of the port.

  * :func:`trace` — a profiler trace (host ops of every thread, and the
    card's kernels when the device is the card) around any block,
    exported as a Chrome trace (view in Perfetto or chrome://tracing);
  * :class:`annotate` — the port's one span: a host stage's wall time,
    added to a timings dict, and, while a profiler runs, a named range in
    that trace beside the card's kernels, on the profiler's clock.

The pipeline puts an ``annotate`` at each host stage boundary, and the
span's name is its timings key (``PipelineOutput``'s docstring lists
them).  A span never synchronizes: where a stage's time must include the
card's work, the stage ends in an explicit ``synchronize``.
"""

from __future__ import annotations

import contextlib
import os
from time import perf_counter as _clock
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "annotate", "TRACE_FILE"]

#: the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda"):
    """Profile the block and write ``log_dir/trace.json``.  The spans of
    every thread are recorded (``segment_files``' reader and writer too),
    and the card's kernels when ``device`` is a CUDA device."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class annotate:
    """``with annotate(name, timings):`` — a span over the block.

    Its wall time (``perf_counter``) is added to ``timings[name]`` when a
    dict is given, so repeated spans of one name sum.  While a profiler
    runs (on any thread) the block is also a
    ``torch.profiler.record_function(name)`` range; otherwise no range
    is entered, and a span costs well under a microsecond.  The test is
    ``torch.autograd.profiler._is_profiler_enabled``, which every profiler
    setting sets for every thread (``torch.autograd._profiler_enabled()``
    reads False under ``profile_all_threads``).
    """

    __slots__ = ("name", "timings", "_t0", "_range")

    def __init__(self, name: str, timings: Optional[dict] = None):
        self.name = name
        self.timings = timings
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = r = torch.profiler.record_function(self.name)
            r.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        t = self.timings
        if t is not None:
            t[self.name] = t.get(self.name, 0.0) + dt
        return False
