"""Wraps the benchmark puts around the port's entry points, from its own
files: the program's code is not changed.

* :func:`capture_stage1` keeps stage 1's outputs of one scan as the
  timed window path made them (on a warm-up scan;
  ``benchmark/paths/window.py``'s ``capture``);
* :func:`kernel_spans` puts a ``bench.kernel.<name>`` span around each
  call of a kernel (the traced scans), so the trace gives its device
  time;
* :func:`kernel_work` counts each call's bytes and operations from its
  inputs (the same scans run again, untraced).
"""

from __future__ import annotations

import contextlib
import importlib
import os
from typing import Dict, List

import torch

from benchmark.harness.trace import KERNEL_SPAN

#: build and kernel caches, at a fixed place in the checkout (gitignored)
CACHE_DIR = ".bench_cache"


@contextlib.contextmanager
def patched(obj, name: str, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _host(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def capture_stage1(into: list):
    """Stage 1's outputs of the pipeline runs inside the block, one dict a
    scan appended to ``into`` in the order the scans run: the sorted
    positions the stats sweep reads and its k-th distances, normals and
    curvature, in the Morton order."""
    from buildingsegment_tpu_torch import pipeline

    def stats(orig):
        def wrap(spos, smask, *a, **kw):
            dk, nrm, curv = orig(spos, smask, *a, **kw)
            into.append(dict(spos=_host(spos), kth_sq_dist=_host(dk),
                             normals=_host(nrm), curvature=_host(curv)))
            return dk, nrm, curv
        return wrap

    with patched(pipeline, "knn_normals_window_stats", stats):
        yield into


def roofline_kernels(cell) -> List[str]:
    """The kernels whose ``<kernel>_roofline`` the cell reports."""
    suffix = "_roofline"
    return [m["name"][:-len(suffix)] for m in cell.per_layer
            if m["name"].endswith(suffix)]


def _roofline_module(kernel: str):
    return importlib.import_module(f"benchmark.roofline.{kernel}")


@contextlib.contextmanager
def kernel_spans(kernels: List[str]):
    """A ``bench.kernel.<kernel>`` span around each call of the kernels'
    entry points inside the block."""
    from buildingsegment_tpu_torch import kernels as port_kernels

    with contextlib.ExitStack() as stack:
        for k in kernels:
            def make(orig, name=KERNEL_SPAN + k):
                def wrap(*a, **kw):
                    with torch.profiler.record_function(name):
                        return orig(*a, **kw)
                return wrap
            stack.enter_context(patched(
                port_kernels, _roofline_module(k).ENTRY, make))
        yield


@contextlib.contextmanager
def kernel_work(kernels: List[str], into: Dict[str, list]):
    """Each call's (bytes, operations) of the kernels inside the block,
    appended to ``into[kernel]``."""
    from buildingsegment_tpu_torch import kernels as port_kernels

    with contextlib.ExitStack() as stack:
        for k in kernels:
            mod = _roofline_module(k)
            calls = into.setdefault(k, [])

            def make(orig, mod=mod, calls=calls):
                def wrap(*a, **kw):
                    out = orig(*a, **kw)
                    calls.append(mod.work(a, kw, out))
                    return out
                return wrap
            stack.enter_context(patched(port_kernels, mod.ENTRY, make))
        yield


def cache_dirs(root: str) -> Dict[str, str]:
    """Fixed build and kernel cache directories inside the checkout, for
    what the program or its libraries compile (Triton, extensions)."""
    base = os.path.join(root, CACHE_DIR)
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions")}
