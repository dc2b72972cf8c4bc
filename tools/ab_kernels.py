#!/usr/bin/env python3
"""Time kernels of one checkout of the PyTorch port on the paths' inputs.

Run on a machine with an NVIDIA card:

    python3 tools/ab_kernels.py [--repo DIR] [--label NAME]
        [--kernels compact_sweep,payload_moment_sums | main] [--reps 50]

Imports ``buildingsegment_tpu_torch`` from DIR (default: this
repository's root; an older commit unpacked with ``git archive`` works
the same), builds its kernels, and runs ``segment_cloud`` three times:
on chip_smoke.py's slice scene (222,828 points) under ``DEFAULT_CONFIG``
and under ``seg_group=1``, and on BASELINE config 5's scan 0 (the house
at 25 mm spacing, seed 0, 1,082,304 points) at capacity 1,179,648.
Each run captures the inputs of every call of the chosen kernels'
wrappers (any of ``SPIES``; ``main``: the default path's eight), spied
where the solvers call them, as chip_smoke.py does;
each kernel is then timed on the first call at its largest row count
with CUDA events (one warm-up call, then ``--reps`` calls back to back:
``ms``, which includes the wrapper's host time wherever that exceeds the
device's; ``host_ms``, the host's time to issue a call), then the same
calls again under ``torch.profiler``: the
device time of each CUDA kernel the wrapper launched, per call
(``device_ms``, its sum ``device_ms_total``).  Prints the card line,
then one JSON line.  To compare two commits on one
card, run it in turns from one command: parent, change, change, parent.
Exits non-zero without a card.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HOUSE = dict(width_mm=12000.0, depth_mm=9000.0, wall_h_mm=6000.0,
             ridge_h_mm=8000.0, noise_mm=8.0)
# kernel → (module under the package, attribute the solver calls, wrapper
# in kernels.py, the argument whose length is the call's row count)
SPIES = {
    "compact_sweep": ("seg.region_grow", "compact_sweep",
                      "compact_sweep_cuda", 4),
    "payload_moment_sums": ("seg.coarse", "plane_payload_moment_sums",
                            "payload_moment_sums_cuda", 0),
    "label_sweep": ("seg.region_grow", "label_sweep", "label_sweep_cuda", 4),
    "plane_adopt": ("seg.coarse", "plane_adopt", "plane_adopt_cuda", 1),
    "stats_sweep": ("ops.stats_sweep", "stats_sweep", "stats_sweep_cuda", 1),
    "seed_sweep": ("seg.region_grow", "seed_sweep", "seed_sweep_cuda", 2),
    "refine_sweep": ("seg.coarse", "refine_sweep", "refine_sweep_cuda", 2),
    "table_lookup": ("seg.coarse", "table_lookup", "table_lookup_cuda", 0),
}
#: ``--kernels main``: every kernel of the default path
MAIN = ("stats_sweep", "seed_sweep", "label_sweep", "compact_sweep",
        "refine_sweep", "payload_moment_sums", "table_lookup", "plane_adopt")


def clone(torch, x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(torch, v) for v in x)
    return x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default="compact_sweep,payload_moment_sums")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    names = list(MAIN) if args.kernels == "main" else args.kernels.split(",")
    sys.path.insert(0, os.path.abspath(args.repo))

    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)

    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.pipeline import (
        DEFAULT_CONFIG, HostPointCloud, PipelineConfig, _bucket_capacity,
        segment_cloud,
    )
    from buildingsegment_tpu_torch.utils import make_building_cloud

    pkg = os.path.dirname(os.path.abspath(kernels.__file__))
    build_s = kernels.build()
    slice_pts, _ = make_building_cloud(seed=0, spacing_mm=55.0, **HOUSE)
    scan0, _ = make_building_cloud(seed=0, spacing_mm=25.0, **HOUSE)
    runs = {
        "slice_default": (slice_pts, DEFAULT_CONFIG),
        "slice_single_level": (slice_pts, PipelineConfig(
            knn_method="window", seg_group=1, pad_to_multiple=2048)),
        "config5_scan0": (scan0, dataclasses.replace(
            DEFAULT_CONFIG,
            pad_to_multiple=_bucket_capacity(len(scan0), DEFAULT_CONFIG))),
    }
    out = {"card": card, "label": args.label, "package": pkg,
           "build_s": build_s, "reps": args.reps, "runs": {}}
    for run, (pts, cfg) in runs.items():
        seen = {name: [] for name in names}
        orig = {}
        for name in names:
            mod_name, attr = SPIES[name][:2]
            mod = importlib.import_module(f"buildingsegment_tpu_torch.{mod_name}")
            orig[name] = (mod, getattr(mod, attr))

            def spy(*a, _name=name, **kw):
                seen[_name].append((clone(torch, a), dict(kw)))
                return orig[_name][1](*a, **kw)
            setattr(mod, attr, spy)
        try:
            res = segment_cloud(HostPointCloud(positions=pts), cfg,
                                device="cuda")
        finally:
            for name in names:
                mod, fn = orig[name]
                setattr(mod, SPIES[name][1], fn)
        rec = {"points": len(pts), "planes": res.num_planes}
        for name in names:
            calls = seen[name]
            if not calls:
                rec[name] = None
                continue
            rows = [a[SPIES[name][3]].shape[0] for a, _kw in calls]
            a, kw = calls[rows.index(max(rows))]
            fn = getattr(kernels, SPIES[name][2])
            fn(*a, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(*a, **kw)
            host = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    fn(*a, **kw)
                torch.cuda.synchronize()
            dev = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                if us > 0 and "CUDA" in str(e.device_type):
                    key = e.key.replace("(anonymous namespace)::", "")[:60]
                    dev[key] = dev.get(key, 0.0) + us / 1e3 / args.reps
            rec[name] = {"calls": len(calls), "rows": max(rows),
                         "ms": start.elapsed_time(end) / args.reps,
                         "host_ms": host * 1e3 / args.reps,
                         "device_ms_total": sum(dev.values()),
                         "device_ms": dev}
        out["runs"][run] = rec
        del seen
    print(json.dumps(out))


if __name__ == "__main__":
    main()
