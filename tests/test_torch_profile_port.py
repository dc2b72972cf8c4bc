"""``tools/profile_port.py``'s device busy count, on the CPU.

The profiler lists the ``profiling.annotate`` stage spans on the card's
timeline too; each covers the kernels inside it, so counting them as
device work counted those kernels twice (a busy time above the host
span).  ``device_rows`` keeps kernels, copies and fills in the busy time
and lists the spans apart.  The CPU has no device rows, so the split is
held on profiler rows built here, and a real CPU profile shows that the
profiler flags an ``annotate`` span as a user annotation.
"""

import importlib.util
import os
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile

from buildingsegment_tpu_torch.profiling import annotate

_TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "profile_port.py")


def _tool():
    spec = importlib.util.spec_from_file_location("profile_port", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(key, count, us, device="DeviceType.CUDA", span=False):
    return SimpleNamespace(key=key, count=count, device_type=device,
                           self_device_time_total=us,
                           is_user_annotation=span)


def test_device_rows_leave_spans_out_of_busy():
    """Kernels, copies and fills count once; the stage spans go apart;
    CPU rows and rows without device time go nowhere."""
    rows = [
        _row("segmentation", 3, 240_000.0, span=True),
        _row("segsort::pass_kernel<2, 1>", 18, 900.0),
        _row("Memcpy HtoD (Pageable -> Device)", 6, 450.0),
        _row("stage1", 3, 30_000.0, span=True),
        _row("Memset (Device)", 9, 12.0),
        _row("aten::index_put_", 9, 0.0, device="DeviceType.CPU"),
        _row("idle kernel", 1, 0.0),
    ]
    prof = SimpleNamespace(key_averages=lambda: rows)
    work, spans = _tool().device_rows(prof)
    assert [r[0] for r in work] == ["segsort::pass_kernel<2, 1>",
                                    "Memcpy HtoD (Pageable -> Device)",
                                    "Memset (Device)"]
    assert [r[0] for r in spans] == ["segmentation", "stage1"]
    assert sum(r[2] for r in work) == 1362.0
    assert work[0][1] == 18


def test_annotate_spans_are_user_annotations():
    """The profiler marks an ``annotate`` span as a user annotation, the
    flag ``device_rows`` reads, and the ops inside it are not."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("stage1"):
            torch.ones(64).mul_(2.0)
    flags = {e.key: e.is_user_annotation for e in prof.key_averages()}
    assert flags["stage1"] is True
    assert flags["aten::mul_"] is False
