"""Run the sharded pipeline on bench.py's scene and hold it against the
one-device run.

    python -m buildingsegment_tpu_torch.dist.check --world 4
    python -m buildingsegment_tpu_torch.dist.check --world 2 --backend gloo
    python -m buildingsegment_tpu_torch.dist.check --world 2 --device cpu --spacing-mm 250

Spawns ``--world`` ranks (NCCL with one card a rank by default; gloo to
share cards or on the CPU), each running ``sharded_pipeline`` under
``DEFAULT_CONFIG`` (``--mxu``: the block-form fields) twice on the whole
input: a warm-up, then a measured run with the kernel launch counts set
to 0 just before and read just after.  The parent runs the one-device
``run_device_pipeline`` of the same configuration with the compact loop
off above world 1 (it has no sharded form).  Prints per rank the wall
time, sweeps, host syncs, collective counts and launches, then one JSON
line; exits 1 unless labels, plane count and plane sizes are equal bit
for bit.  The scene is ``make_building_cloud(seed=0, spacing_mm=25,
12000 × 9000, walls 6000, ridge 8000, noise 8)``: 1,082,304 points at
capacity 1,179,648.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.config import DEFAULT_CONFIG
from buildingsegment_tpu_torch.dist import sharded_pipeline, spawn
from buildingsegment_tpu_torch.pipeline import run_device_pipeline
from buildingsegment_tpu_torch.utils import make_building_cloud
from buildingsegment_tpu_torch.utils.device import synchronize

SCENE = dict(seed=0, width_mm=12000.0, depth_mm=9000.0, wall_h_mm=6000.0,
             ridge_h_mm=8000.0, noise_mm=8.0)
#: seconds the ranks may take, start-up and both runs included
TIMEOUT_S = 600.0


def _config(mxu: bool):
    if not mxu:
        return DEFAULT_CONFIG
    return dataclasses.replace(DEFAULT_CONFIG, stats_rank_mode="mxu",
                               seg_seed_mode="mxu")


def _rank(group, pos, mask, mxu):
    """One rank: a warm-up run, then the measured run."""
    if group.device.type == "cuda":
        kernels.build()
    p = torch.from_numpy(pos).to(group.device)
    m = torch.from_numpy(mask).to(group.device)
    fn = sharded_pipeline(group, _config(mxu))
    fn(p, m)
    synchronize(group.device)
    group.barrier()
    group.stats.reset()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _s, _lo, seg = fn(p, m)
    synchronize(group.device)
    wall = time.perf_counter() - t0
    out = {"rank": group.rank, "device": str(group.device),
           "wall_ms": wall * 1e3, "num_planes": seg.num_planes,
           "num_sweeps": seg.num_sweeps, "host_syncs": seg.host_syncs,
           "collectives": dict(vars(group.stats)),
           "launches": {k: v for k, v in kernels.launch_counts.items() if v},
           "plane_count": seg.plane_count.cpu().numpy()}
    if group.rank == 0:
        out["plane_idx"] = seg.plane_idx.cpu().numpy()
    return out


def one_device_run(pos, mask, cfg, device, compact):
    """``run_device_pipeline`` of ``cfg``'s window path with ``seg_compact
    = compact`` and no host hints (what ``sharded_pipeline`` computes) on
    numpy inputs: a warm-up, then a timed run → (SegmentationResult, ms)."""
    p = torch.from_numpy(pos).to(device)
    m = torch.from_numpy(mask).to(device)
    kw = dict(
        k_search=max(cfg.knn_k_pad, cfg.normal_max_nn), knn_k=cfg.knn_k,
        normal_radius=cfg.normal_radius, normal_max_nn=cfg.normal_max_nn,
        th_thickness=cfg.th_thickness, th_normal_cos=cfg.th_normal_cos,
        th_point_count=cfg.th_point_count, max_planes=cfg.max_planes,
        max_sweeps=cfg.max_sweeps, knn_method="window",
        knn_window_size=cfg.knn_window,
        th_seed_curvature=cfg.th_seed_curvature,
        convergence_tol=cfg.seg_convergence_tol, seg_group=cfg.seg_group,
        seg_levels=cfg.seg_levels, seg_refine_sweeps=cfg.seg_refine_sweeps,
        seg_anchor_cos=cfg.seg_anchor_cos, seg_compact=compact,
        seg_seed_source=cfg.seg_seed_source, seg_seed_mode=cfg.seg_seed_mode,
        stats_rank_mode=cfg.stats_rank_mode, morton_small=cfg.morton_small,
        spacing_hint_mm=cfg.spacing_hint_mm)
    run_device_pipeline(p, m, **kw)  # warm-up
    synchronize(p.device)
    t0 = time.perf_counter()
    _s, _lo, seg = run_device_pipeline(p, m, **kw)
    synchronize(p.device)
    return seg, (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m buildingsegment_tpu_torch.dist.check")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--device", default=None,
                    help="'cpu', or none for the card of each rank")
    ap.add_argument("--spacing-mm", type=float, default=25.0)
    ap.add_argument("--mxu", action="store_true")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    backend = args.backend or ("gloo" if on_cpu else "nccl")
    if not on_cpu and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 1
    pts, _truth = make_building_cloud(spacing_mm=args.spacing_mm, **SCENE)
    n = len(pts)
    cap = DEFAULT_CONFIG.padded_count(n)
    span = args.world * DEFAULT_CONFIG.seg_group ** DEFAULT_CONFIG.seg_levels
    cap = -(-cap // span) * span
    pos = np.full((cap, 3), 1 << 24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    cfg = _config(args.mxu)
    compact = cfg.seg_compact if args.world == 1 else False
    ref, ref_ms = one_device_run(pos, mask, cfg, "cpu" if on_cpu else "cuda",
                                 compact)
    # the ranks import the rank function by its module's name, which is
    # not __main__ here
    from buildingsegment_tpu_torch.dist import check

    ranks = spawn(check._rank, args.world, backend=backend,
                  device=args.device, timeout_s=TIMEOUT_S,
                  args=(pos, mask, args.mxu))
    got = ranks[0]
    same = (np.array_equal(got["plane_idx"], ref.plane_idx.cpu().numpy())
            and got["num_planes"] == ref.num_planes
            and np.array_equal(got["plane_count"],
                               ref.plane_count.cpu().numpy()))
    card = ("cpu" if on_cpu else
            f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")
    for r in ranks:
        print(f"rank {r['rank']} ({r['device']}): {r['wall_ms']:.3f} ms, "
              f"{r['num_planes']} planes, {r['num_sweeps']} sweeps, "
              f"{r['host_syncs']} host syncs, collectives "
              f"{r['collectives']}, launches {r['launches']}")
    print(f"one device (seg_compact={compact}): {ref_ms:.3f} ms, "
          f"{ref.num_planes} planes; sharded == one device: {same} "
          f"({card})")
    print(json.dumps({
        "points": n, "capacity": cap, "world": args.world,
        "backend": backend, "mxu": args.mxu, "equal": same, "card": card,
        "one_device_ms": ref_ms, "one_device_compact": compact,
        "ranks": [{k: v for k, v in r.items()
                   if k not in ("plane_idx", "plane_count")} for r in ranks],
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
