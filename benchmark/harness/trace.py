"""The traced part of a ``--trace 1`` run: a ``torch.profiler`` trace of a
few whole scans after the window, read into busy time, the device
operations that took most time, the idle gaps by what the host was doing,
and the device time of each wrapped kernel call."""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness.arith import Coverage, covered, gaps

#: the span around the traced scans (its length is ``window_s``)
WINDOW_SPAN = "bench.traced"
#: prefix of the spans the benchmark puts around one kernel call
KERNEL_SPAN = "bench.kernel."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
#: a device operation's name is cut to this many characters (the
#: templates of PyTorch's kernels run to thousands)
NAME_CHARS = 120


def profile_block(run: Callable[[], None], device: torch.device,
                  tmpdir: str) -> dict:
    """Run ``run()`` under the profiler and read its trace (see
    :func:`summarize`).  The trace file is deleted once read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(tmpdir, "bench_trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, device.index or 0)


def _is_device_op(e: dict, dev: int) -> bool:
    if str(e.get("cat", "")).lower() not in DEVICE_CATS or "dur" not in e:
        return False
    where = e.get("args", {}).get("device", e.get("pid"))
    try:
        return int(where) == dev
    except (TypeError, ValueError):
        return False


def summarize(events: List[dict], dev: int) -> dict:
    """``window_s`` (the traced span), ``busy_s`` (the union of the card's
    kernels, copies and fills inside it), ``device_ops`` (the operations
    that took most device time, summed by name), ``idle_gaps`` (the
    card's idle time inside the span by the innermost ``profiling.annotate``
    span of the port open on the host at each gap's midpoint, or "host, no
    span"), ``kernel_device_s`` ({kernel: device seconds of each wrapped
    call}).  All in seconds."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and str(e.get("cat", "")).lower() == "user_annotation"]
    if not window:
        raise ValueError("the trace has no traced span")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    ops = [e for e in events if _is_device_op(e, dev)]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in ops]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in ops:
        by_name[str(e["name"])[:NAME_CHARS]] += e["dur"]
    spans = [e for e in events
             if str(e.get("cat", "")).lower() == "user_annotation"
             and "dur" in e and not str(e["name"]).startswith("bench.")]
    idle: Dict[str, float] = collections.defaultdict(float)
    cov = Coverage(iv)
    for a, b in gaps(iv, w0, w1):
        mid = (a + b) / 2
        inside = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        name = (min(inside, key=lambda s: s["dur"])["name"] if inside
                else "host, no span")
        idle[name] += b - a
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": cov(w0, w1) / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "kernel_device_s": _kernel_calls(events, ops, iv),
    }


def _kernel_calls(events: List[dict], ops: List[dict],
                  iv: list) -> Dict[str, List[float]]:
    """Device seconds of each call inside a ``bench.kernel.<name>`` span:
    the card's work inside the span's device range where the trace has
    one (``gpu_user_annotation``), else the work whose launch lies inside
    the host span (by the launches' correlation ids)."""
    out: Dict[str, List[float]] = collections.defaultdict(list)
    dev_spans = [e for e in events
                 if str(e.get("cat", "")).lower() == "gpu_user_annotation"
                 and str(e.get("name", "")).startswith(KERNEL_SPAN)]
    host = [e for e in events
            if str(e.get("cat", "")).lower() == "user_annotation"
            and str(e.get("name", "")).startswith(KERNEL_SPAN)]
    if dev_spans and len(dev_spans) == len(host):
        cov = Coverage(iv)
        for s in sorted(dev_spans, key=lambda s: s["ts"]):
            out[s["name"][len(KERNEL_SPAN):]].append(
                cov(s["ts"], s["ts"] + s["dur"]) / 1e6)
        return dict(out)
    launches = sorted(
        ((e["ts"], e["args"]["correlation"]) for e in events
         if str(e.get("cat", "")).lower() in ("cuda_runtime", "cuda_driver")
         and "correlation" in e.get("args", {})))
    times = [t for t, _c in launches]
    by_corr = collections.defaultdict(list)
    for e in ops:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr].append((e["ts"], e["ts"] + e["dur"]))
    for s in sorted(host, key=lambda s: s["ts"]):
        lo, hi = s["ts"], s["ts"] + s["dur"]
        a, b = bisect.bisect_left(times, lo), bisect.bisect_right(times, hi)
        mine = [iv_ for _t, corr in launches[a:b]
                for iv_ in by_corr.get(corr, [])]
        out[s["name"][len(KERNEL_SPAN):]].append(covered(mine) / 1e6)
    return dict(out)


def idle_pct(profile: Optional[dict]) -> Optional[float]:
    """The card's idle share of the traced span, in %."""
    if not profile or profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
