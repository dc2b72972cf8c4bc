#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's segmentation on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/profile_port.py [--config default|single_level|pallas|brute|render|multiscan] [--runs 3]

Builds the slice scene (222,828 points, the scene of chip_smoke.py; for
``--config brute`` the same house at 105 mm spacing, 60,914 points,
where ``DEFAULT_CONFIG``'s "auto" resolves to "brute"), warms
``segment_cloud`` up twice, then runs it ``--runs`` times under
``torch.profiler`` (CPU and CUDA activity).  ``--config multiscan``
profiles BASELINE config 5 instead: ``segment_files`` with the render
over the four ~1.08M-point scans of chip_smoke.py (the house at 25 mm
spacing, seeds 0-3, written to a temporary directory); ``--config
render`` profiles ``render_ortho_views`` on the first of them, after one
``segment_cloud`` at its capacity.  Prints the card line, then one JSON
line: the host span per run (each run ends in the labels' or rasters'
device→host fetch), the device busy time per run (the sum of the device
time of every kernel, copy and fill), the idle share 1 − busy / span,
and the kernels by device time (calls and ms per run).  The profiler
adds host time, so the stage times of ``chip_smoke.py`` are the
unprofiled figures.  Exits non-zero without a card.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def workload(config, tmp):
    """(one run of the configuration as a callable, points it covers)."""
    from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
    from buildingsegment_tpu_torch.io.ply import HostPointCloud, write_ply
    from buildingsegment_tpu_torch.pipeline import (
        _bucket_capacity, segment_cloud, segment_files,
    )
    from buildingsegment_tpu_torch.raster.ortho import render_ortho_views
    from buildingsegment_tpu_torch.utils import make_building_cloud

    house = dict(width_mm=12000.0, depth_mm=9000.0, wall_h_mm=6000.0,
                 ridge_h_mm=8000.0, noise_mm=8.0)
    if config in ("render", "multiscan"):
        # BASELINE config 5's scans, as chip_smoke.py builds them
        scans = [make_building_cloud(seed=s, spacing_mm=25.0, **house)[0]
                 for s in range(1 if config == "render" else 4)]
        if config == "render":
            cfg = dataclasses.replace(DEFAULT_CONFIG, pad_to_multiple=(
                _bucket_capacity(len(scans[0]), DEFAULT_CONFIG)))
            out = segment_cloud(HostPointCloud(positions=scans[0]), cfg,
                                device="cuda")
            render = os.path.join(tmp, "render")
            return (lambda: render_ortho_views(out, render, cfg),
                    len(scans[0]))
        srcs = []
        for s, pts in enumerate(scans):
            srcs.append(os.path.join(tmp, f"scan{s}.ply"))
            write_ply(HostPointCloud(positions=pts), srcs[-1],
                      position_scale=1e-3)
        dsts = [os.path.join(tmp, f"out{s}.ply") for s in range(len(srcs))]
        render = os.path.join(tmp, "render")
        return (lambda: segment_files(srcs, dsts, DEFAULT_CONFIG,
                                      device="cuda", render_dir=render),
                sum(len(p) for p in scans))

    cfg = {
        "default": DEFAULT_CONFIG,
        "single_level": PipelineConfig(knn_method="window", seg_group=1,
                                       pad_to_multiple=2048),
        "pallas": PipelineConfig(knn_method="pallas"),
        "brute": DEFAULT_CONFIG,
    }[config]
    pts, _ = make_building_cloud(
        seed=0, spacing_mm=105.0 if config == "brute" else 55.0, **house)
    cloud = HostPointCloud(positions=pts)
    return lambda: segment_cloud(cloud, cfg, device="cuda"), len(pts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    choices=("default", "single_level", "pallas", "brute",
                             "render", "multiscan"),
                    default="default")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port: no CUDA card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)

    with tempfile.TemporaryDirectory() as tmp:
        run, points = workload(args.config, tmp)
        for _ in range(2):
            run()
        torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.runs):
                run()
            torch.cuda.synchronize()
            span = (time.perf_counter() - t0) / args.runs

    # device-side entries only (kernels, copies, fills): the CPU ops that
    # launched them report the same time again
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((e.key, e.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3 / args.runs
    print(json.dumps({
        "card": card, "config": args.config, "points": points,
        "runs": args.runs, "host_span_ms": span * 1e3,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / (span * 1e3),
        "kernels": [
            {"name": k[:90], "calls_per_run": c / args.runs,
             "ms_per_run": us / 1e3 / args.runs}
            for k, c, us in rows[:args.top]
        ],
    }))


if __name__ == "__main__":
    main()
