#!/usr/bin/env python3
"""Smoke run of the PyTorch port (buildingsegment_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. the card's name and power limit (nvidia-smi); no card → failure;
2. build the CUDA kernels from csrc/ (nvcc, first use) and time it;
3. drive ``segment_file`` once on the slice's scene (222,828 points,
   capacity 223,232) while recording the inputs the solver hands to each
   kernel wrapper; then hold each kernel against its plain PyTorch
   version on those inputs (label_sweep after stage 1 and the singleton
   sweep, compact_sweep at its first compact sweep) — both must match
   bit for bit — and time both with CUDA events;
4. small-input check: the same pipeline on a 9k-point scene on the card
   and on the CPU (plain versions) — same plane count, cross agreement
   ≥ 0.99;
5. the measured main-path run: launch counts reset, ``segment_file`` on
   the slice's scene, counts read; every kernel must have launched; the
   output PLY is re-read and checked; 8 planes at truth agreement
   ≥ 0.9633 (the JAX package's 0.9733 on this scene, − 0.01).

The last two lines of stdout are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile

SCENE = dict(seed=0, spacing_mm=55.0, width_mm=12000.0, depth_mm=9000.0,
             wall_h_mm=6000.0, ridge_h_mm=8000.0, noise_mm=8.0)
SCENE_POINTS = 222828
SMALL_SCENE = dict(seed=5, spacing_mm=120.0, width_mm=5000.0,
                   depth_mm=4000.0, wall_h_mm=3000.0, ridge_h_mm=4000.0)
EXPECT_PLANES = 8
MIN_TRUTH_BIJ = 0.9633


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    import numpy as np

    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.ops import compact_sweep, window_sweep
    from buildingsegment_tpu_torch.pipeline import (
        HostPointCloud, PipelineConfig, read_ply, segment_cloud,
        segment_file, write_ply,
    )
    from buildingsegment_tpu_torch.seg import region_grow
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    # 2. build
    t_build = kernels.build(verbose=True)
    print(f"build: {t_build:.2f} s (0 = library already built)")

    cfg = PipelineConfig(knn_method="window", seg_group=1,
                         pad_to_multiple=2048)
    pts, truth = make_building_cloud(**SCENE)
    if len(pts) != SCENE_POINTS:
        fail(f"scene has {len(pts)} points, expected {SCENE_POINTS}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "scene.ply")
        dst = os.path.join(tmp, "labeled.ply")
        # metres in the file; read ×1000 → integer mm (TMC3.cpp:207)
        write_ply(HostPointCloud(positions=pts), src, position_scale=0.001)

        # 3. capture the wrappers' inputs on a full run (also the warm-up)
        captured = {"label_sweep": [], "compact_sweep": []}

        def spy(name, fn):
            def call(*args, **kw):
                if len(captured[name]) < 2:
                    captured[name].append((args, kw))
                return fn(*args, **kw)
            return call

        orig = (region_grow.label_sweep, region_grow.compact_sweep)
        region_grow.label_sweep = spy("label_sweep", orig[0])
        region_grow.compact_sweep = spy("compact_sweep", orig[1])
        try:
            warm = segment_file(src, dst, cfg, device="cuda")
        finally:
            region_grow.label_sweep, region_grow.compact_sweep = orig
        if not captured["label_sweep"] or not captured["compact_sweep"]:
            fail(f"solver did not reach both kernels: "
                 f"{ {k: len(v) for k, v in captured.items()} }")
        print(f"warm-up run: {warm.num_planes} planes, "
              f"{warm.num_sweeps} sweeps")

        # label_sweep: the first warm sweep after the singleton sweep
        la, lkw = captured["label_sweep"][-1]
        k_out = kernels.label_sweep_cuda(*la, **lkw)
        p_out = window_sweep.label_sweep_reference(*la, **lkw)
        torch.cuda.synchronize()
        label_err = max(int((k - p).abs().max()) for k, p in zip(k_out, p_out))
        if not all(torch.equal(k, p) for k, p in zip(k_out, p_out)):
            fail(f"label_sweep kernel != plain version (max err {label_err})")
        label_ms = cuda_ms(torch, lambda: kernels.label_sweep_cuda(*la, **lkw), 50)
        label_plain_ms = cuda_ms(
            torch, lambda: window_sweep.label_sweep_reference(*la, **lkw), 5)
        n_rows = la[4].shape[0]
        print(f"label_sweep n={n_rows} w={lkw['w']}: kernel == plain; "
              f"{label_ms:.4f} ms vs plain {label_plain_ms:.4f} ms ({card})")

        # compact_sweep: the first compact sweep
        ca, ckw = captured["compact_sweep"][0]
        k_lab, k_cnt = kernels.compact_sweep_cuda(*ca, **ckw)
        p_lab, p_cnt = compact_sweep.compact_sweep_reference(*ca, **ckw)
        torch.cuda.synchronize()
        compact_err = int((k_lab - p_lab).abs().max())
        if not (torch.equal(k_lab, p_lab) and torch.equal(k_cnt, p_cnt)):
            fail(f"compact_sweep kernel != plain version: labels max err "
                 f"{compact_err}, counters {k_cnt.tolist()} vs "
                 f"{p_cnt.tolist()}")
        compact_ms = cuda_ms(
            torch, lambda: kernels.compact_sweep_cuda(*ca, **ckw), 20)
        compact_plain_ms = cuda_ms(
            torch, lambda: compact_sweep.compact_sweep_reference(*ca, **ckw), 3)
        print(f"compact_sweep n={ca[4].shape[0]} w={ckw['w']} "
              f"lc={ckw['lc']} bound={ca[6]}: kernel == plain "
              f"(changed {k_cnt.tolist()[0]}); {compact_ms:.4f} ms vs plain "
              f"{compact_plain_ms:.4f} ms ({card})")
        del captured, la, lkw, ca, ckw

        # 4. small input: card (kernels) vs CPU (plain versions)
        spts, _ = make_building_cloud(**SMALL_SCENE)
        small_gpu = segment_cloud(HostPointCloud(positions=spts), cfg,
                                  device="cuda")
        small_cpu = segment_cloud(HostPointCloud(positions=spts), cfg,
                                  device="cpu")
        cross = bij_agreement(small_cpu.plane_idx, small_gpu.plane_idx)
        if small_gpu.num_planes != small_cpu.num_planes or cross < 0.99:
            fail(f"small scene: card {small_gpu.num_planes} planes vs CPU "
                 f"{small_cpu.num_planes}, cross agreement {cross}")
        print(f"small scene ({len(spts)} points): card == CPU "
              f"{small_cpu.num_planes} planes, cross agreement {cross:.4f}")

        # 5. the measured main-path run
        kernels.reset_launch_counts()
        out = segment_file(src, dst, cfg, device="cuda")
        launches = dict(kernels.launch_counts)
        for name, count in launches.items():
            if count == 0:
                fail(f"main path never launched {name}")

        with open(dst, "rb") as f:
            head = f.read(1024).split(b"end_header")[0].decode()
        for line in ("format binary_little_endian 1.0",
                     f"element vertex {len(pts)}",
                     "property uchar green", "property uchar blue",
                     "property uchar red"):
            if line not in head:
                fail(f"output PLY header lacks {line!r}")
        back = read_ply(dst)
        if back.count != len(pts):
            fail(f"output PLY has {back.count} points, expected {len(pts)}")
        labeled = out.plane_idx > 0
        colors = back.colors
        if not ((colors[labeled] >= 55).all() and (colors[~labeled] == 0).all()):
            fail("output PLY colors do not follow the plane labels")
        if len(np.unique(colors[labeled], axis=0)) != out.num_planes:
            fail("output PLY does not hold one color per plane")
        if not np.isfinite(out.plane_normals).all():
            fail("non-finite plane normals")
        bij = bij_agreement(truth, out.plane_idx)
        if out.num_planes != EXPECT_PLANES or bij < MIN_TRUTH_BIJ:
            fail(f"{out.num_planes} planes at truth agreement {bij:.4f}; "
                 f"expected {EXPECT_PLANES} at >= {MIN_TRUTH_BIJ}")

    stages = {k: round(v, 6) for k, v in out.timings.items()}
    print(json.dumps({
        "slice": {"points": len(pts), "planes": out.num_planes,
                  "truth_bij": round(bij, 6), "num_sweeps": out.num_sweeps,
                  "host_syncs": out.host_syncs, "card": card},
        "stages_s": stages,
    }))
    src_dir = "buildingsegment_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "label_sweep", "route": "cuda",
         "source": f"{src_dir}/label_sweep.cu",
         "replaces": "buildingsegment_tpu/ops/window_sweep.py:731",
         "launches": launches["label_sweep"], "max_abs_err": label_err,
         "ms": label_ms, "plain_ms": label_plain_ms},
        {"name": "compact_sweep", "route": "cuda",
         "source": f"{src_dir}/compact_sweep.cu",
         "replaces": "buildingsegment_tpu/ops/compact_sweep.py:100",
         "launches": launches["compact_sweep"], "max_abs_err": compact_err,
         "ms": compact_ms, "plain_ms": compact_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
