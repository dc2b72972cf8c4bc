#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's segmentation on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/profile_port.py [--config default|single_level|pallas|brute] [--runs 3]

Builds the slice scene (222,828 points, the scene of chip_smoke.py; for
``--config brute`` the same house at 105 mm spacing, 60,914 points,
where ``DEFAULT_CONFIG``'s "auto" resolves to "brute"), warms
``segment_cloud`` up twice, then runs it ``--runs`` times under
``torch.profiler`` (CPU and CUDA activity).  Prints the card line, then
one JSON line: the host span per run (each run ends in the labels'
device→host fetch), the device busy time per run (the sum of the device
time of every kernel, copy and fill), the idle share 1 − busy / span,
and the kernels by device time (calls and ms per run).  The profiler
adds host time, so the stage times of ``chip_smoke.py`` are the
unprofiled figures.  Exits non-zero without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    choices=("default", "single_level", "pallas", "brute"),
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

    from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
    from buildingsegment_tpu_torch.io.ply import HostPointCloud
    from buildingsegment_tpu_torch.pipeline import segment_cloud
    from buildingsegment_tpu_torch.utils import make_building_cloud

    cfg = {
        "default": DEFAULT_CONFIG,
        "single_level": PipelineConfig(knn_method="window", seg_group=1,
                                       pad_to_multiple=2048),
        "pallas": PipelineConfig(knn_method="pallas"),
        "brute": DEFAULT_CONFIG,
    }[args.config]
    pts, _ = make_building_cloud(
        seed=0, spacing_mm=105.0 if args.config == "brute" else 55.0,
        width_mm=12000.0, depth_mm=9000.0, wall_h_mm=6000.0,
        ridge_h_mm=8000.0, noise_mm=8.0,
    )
    cloud = HostPointCloud(positions=pts)
    for _ in range(2):
        segment_cloud(cloud, cfg, device="cuda")
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            segment_cloud(cloud, cfg, device="cuda")
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
        "card": card, "config": args.config, "points": len(pts),
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
