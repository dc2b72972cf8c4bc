#!/usr/bin/env python3
"""Smoke run of the PyTorch port (buildingsegment_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. the card's name and power limit (nvidia-smi); no card → failure;
2. build the CUDA kernels from csrc/ (nvcc, one process per source) and
   time it;
3. drive ``segment_file`` once on the slice's scene (222,828 points,
   capacity 223,232) under ``DEFAULT_CONFIG`` (the multigrid path:
   stats sweep, fine seeds, two coarsening levels, window solve with the
   compact loop, refine, finalize) and once under the single-level
   configuration ``seg_group=1``, recording the inputs each path hands
   to every kernel wrapper;
4. hold each of the eight kernels against its plain PyTorch version on
   the inputs of every call the paths made — all must match bit for
   bit — and time both with CUDA events at the largest call, beside the
   kernel's bound (the bytes the function must move over 3.35 TB/s or
   the f32 operations it needs over 67 TFLOP/s, the H100 SXM's
   published peaks, counted from this run's data);
5. small-input check: both configurations on a 9k-point scene on the
   card and on the CPU (plain versions) — same plane count, cross
   agreement ≥ 0.99;
6. the measured runs: for each path, launch counts reset, ``segment_file``
   on the slice's scene, counts read; every kernel of the path must have
   launched; the output PLY is re-read and checked; the default path
   gives 7 planes at truth agreement ≥ 0.9723 (the JAX package's
   0.982314 on this scene on the CPU, − 0.01), the single-level path
   8 planes at ≥ 0.9633 (0.9733 − 0.01).  Three more default-path runs
   give the stage times.

The last three lines of stdout are the card line, the kernels' JSON
record and ``{"ok": true, "device": {...}}``.
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
# (planes, least truth agreement) per path: the JAX package's CPU result
# on this scene, agreement − 0.01
EXPECT = {"default": (7, 0.9723), "single_level": (8, 0.9633)}
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SRC = "buildingsegment_tpu_torch/csrc"
JAX_OPS = "buildingsegment_tpu/ops"
# kernel → (CUDA source, the TPU kernel it replaces, timing reps for the
# kernel and for its plain version)
KERNELS = {
    "stats_sweep": ("stats_sweep.cu", "stats_sweep.py:100", 50, 3),
    "seed_sweep": ("seed_sweep.cu", "window_sweep.py:519", 50, 3),
    "label_sweep": ("label_sweep.cu", "window_sweep.py:731", 50, 5),
    "compact_sweep": ("compact_sweep.cu", "compact_sweep.py:100", 20, 3),
    "refine_sweep": ("refine_sweep.cu", "window_sweep.py:332", 50, 3),
    "payload_moment_sums": ("segsum.cu", "segsum.py:315", 50, 3),
    "table_lookup": ("segsum.cu", "segsum.py:141", 50, 5),
    "plane_adopt": ("adopt.cu", "adopt.py:87", 50, 3),
}
SINGLE_LEVEL = ("label_sweep", "compact_sweep")
# the wrapper argument whose length is the call's row count
ROWS_ARG = {"stats_sweep": 1, "seed_sweep": 2, "label_sweep": 4,
            "compact_sweep": 4, "refine_sweep": 2, "payload_moment_sums": 0,
            "table_lookup": 0, "plane_adopt": 1}


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


def window_pairs(torch, mask, w):
    """Valid (row, candidate) pairs of a ±w window: the candidate tests a
    window kernel must make on these inputs."""
    m = mask.to(torch.int64)
    c = torch.cumsum(torch.cat([m.new_zeros(1), m]), 0)
    n = m.shape[0]
    i = torch.arange(n, device=m.device)
    lo, hi = (i - w).clamp(0, n), (i + w + 1).clamp(0, n)
    return int(((c[hi] - c[lo] - m) * m).sum())


def work(torch, name, args, kw, out):
    """(bytes each input read once and each output written once, f32
    operations these inputs need) of one wrapper call.  Where the function
    reads only some rows of an input (the payload of live or hole rows),
    only those count."""
    def nbytes(xs):
        total = 0
        for x in xs:
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
            elif isinstance(x, (tuple, list)):
                total += nbytes(x)
        return total

    outs = out if isinstance(out, tuple) else (out,)
    moved = nbytes(args) + nbytes(outs)
    if name == "stats_sweep":
        mask = args[1]
        pairs = window_pairs(torch, mask, kw["w"])
        used = float((out[1] - mask.float()).sum())
        # per pair: d² (8), the radius ∩ cap test (1) and one compare for
        # each of the two order statistics (a selection must look at
        # every candidate once); per neighbour used: the moments (19)
        ops = pairs * (8 + 1 + 2) + used * 19
    elif name == "seed_sweep":
        ops = window_pairs(torch, args[2], kw["w"]) * 22
    elif name in ("label_sweep", "compact_sweep"):
        mask = args[5] if name == "label_sweep" else args[3]
        ops = window_pairs(torch, mask, kw["w"]) * 40
        if name == "compact_sweep":
            ops += args[6] * args[6] * 40 + mask.shape[0] * 16
    elif name == "refine_sweep":
        pid_in, mask = args[3], args[2]
        adopting = int(((pid_in == 0) & mask).sum())
        ops = int(mask.sum()) * 12 + adopting * 2 * kw["w"] * 30
    elif name == "payload_moment_sums":
        ids, payload = args[0], args[1]
        live_bound = -(-args[3] // 128) * 128  # the kernel's live-id bound
        live = int(((ids >= 0) & (ids < live_bound)).sum())
        # the payload is read for live rows only
        moved -= (ids.shape[0] - live) * payload.shape[1] * 4
        ops = live * 23
    elif name == "table_lookup":
        ops = 0
    else:  # plane_adopt
        payload, holes, table = args[0], args[1], args[2]
        nh = int(holes.sum())
        # the payload is read for hole rows only
        moved -= (holes.shape[0] - nh) * payload.shape[1] * 4
        ok_lanes = int((table[9] > 0).sum())
        # per (hole, ok lane): three dots and the three gates (24); per
        # adopted row: its payload added to its lane (8)
        ops = nh * ok_lanes * 24 + int(out[0].sum()) * 8
    return moved, ops


def clone(torch, x):
    """A copy of a wrapper's arguments, so later in-place updates on the
    path do not change what the kernel check sees."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(torch, v) for v in x)
    return x


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    import numpy as np

    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.ops import (
        adopt, compact_sweep, segsum, stats_sweep, window_sweep,
    )
    from buildingsegment_tpu_torch.pipeline import (
        DEFAULT_CONFIG, HostPointCloud, PipelineConfig, read_ply,
        segment_cloud, segment_file, write_ply,
    )
    from buildingsegment_tpu_torch.seg import coarse, region_grow
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    # the module attribute each solver calls, and each kernel's plain
    # version
    hooks = {
        "stats_sweep": (stats_sweep, "stats_sweep",
                        stats_sweep.stats_sweep_reference),
        "seed_sweep": (region_grow, "seed_sweep",
                       window_sweep.seed_sweep_reference),
        "label_sweep": (region_grow, "label_sweep",
                        window_sweep.label_sweep_reference),
        "compact_sweep": (region_grow, "compact_sweep",
                          compact_sweep.compact_sweep_reference),
        "refine_sweep": (coarse, "refine_sweep",
                         window_sweep.refine_sweep_reference),
        "payload_moment_sums": (coarse, "plane_payload_moment_sums",
                                segsum.payload_moment_sums_reference),
        "table_lookup": (coarse, "table_lookup",
                         segsum.table_lookup_reference),
        "plane_adopt": (coarse, "plane_adopt", adopt.plane_adopt_reference),
    }
    cuda_fns = {
        "stats_sweep": kernels.stats_sweep_cuda,
        "seed_sweep": kernels.seed_sweep_cuda,
        "label_sweep": kernels.label_sweep_cuda,
        "compact_sweep": kernels.compact_sweep_cuda,
        "refine_sweep": kernels.refine_sweep_cuda,
        "payload_moment_sums": kernels.payload_moment_sums_cuda,
        "table_lookup": kernels.table_lookup_cuda,
        "plane_adopt": kernels.plane_adopt_cuda,
    }

    # 2. build
    t_build = kernels.build()
    print(f"build: {t_build:.2f} s (0 = library already built)")

    configs = {
        "default": DEFAULT_CONFIG,
        "single_level": PipelineConfig(knn_method="window", seg_group=1,
                                       pad_to_multiple=2048),
    }
    pts, truth = make_building_cloud(**SCENE)
    if len(pts) != SCENE_POINTS:
        fail(f"scene has {len(pts)} points, expected {SCENE_POINTS}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "scene.ply")
        dst = os.path.join(tmp, "labeled.ply")
        # metres in the file; read ×1000 → integer mm (TMC3.cpp:207)
        write_ply(HostPointCloud(positions=pts), src, position_scale=0.001)

        # 3. capture the wrappers' inputs on a full run of each path (also
        # the warm-up): every call, in order
        captured = {path: {} for path in configs}
        for path, cfg in configs.items():
            seen = captured[path]

            def spy(name, fn):
                def call(*args, **kw):
                    n = args[ROWS_ARG[name]].shape[0]
                    seen.setdefault(name, []).append(
                        (n, clone(torch, args), dict(kw)))
                    return fn(*args, **kw)
                return call

            orig = {k: getattr(mod, attr) for k, (mod, attr, _) in
                    hooks.items()}
            for k, (mod, attr, _) in hooks.items():
                setattr(mod, attr, spy(k, orig[k]))
            try:
                warm = segment_file(src, dst, cfg, device="cuda")
            finally:
                for k, (mod, attr, _) in hooks.items():
                    setattr(mod, attr, orig[k])
            want = KERNELS if path == "default" else SINGLE_LEVEL
            missing = [k for k in want if k not in seen]
            if missing:
                fail(f"{path} path did not reach {missing}")
            print(f"warm-up run, {path}: {warm.num_planes} planes, "
                  f"{warm.num_sweeps} sweeps, calls "
                  f"{ {k: len(v) for k, v in seen.items()} }")

        # 4. every captured call of every kernel against its plain version,
        # bit for bit; the first call at the largest row count is timed
        results = {}
        for path, seen in captured.items():
            for name, calls in seen.items():
                err = 0.0
                for n, args, kw in calls:
                    k_out = cuda_fns[name](*args, **kw)
                    p_out = hooks[name][2](*args, **kw)
                    torch.cuda.synchronize()
                    k_t = k_out if isinstance(k_out, tuple) else (k_out,)
                    p_t = p_out if isinstance(p_out, tuple) else (p_out,)
                    e = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(k_t, p_t))
                    if not all(torch.equal(a, b) for a, b in zip(k_t, p_t)):
                        fail(f"{name} ({path} path, {n} rows, kw {kw}): "
                             f"kernel != plain version (max abs err {e})")
                    err = max(err, e)
                big = max(n for n, _a, _k in calls)
                n, args, kw = next(c for c in calls if c[0] == big)
                k_out = cuda_fns[name](*args, **kw)
                reps, plain_reps = KERNELS[name][2:]
                ms = cuda_ms(torch, lambda: cuda_fns[name](*args, **kw), reps)
                plain_ms = cuda_ms(torch, lambda: hooks[name][2](*args, **kw),
                                   plain_reps)
                moved, ops = work(torch, name, args, kw, k_out)
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = ops / F32_OPS_PER_S * 1e3
                results[(path, name)] = dict(
                    rows=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                print(f"{name} ({path} path): {len(calls)} calls, kernel == "
                      f"plain on each; rows={n}: {ms:.4f} ms vs plain "
                      f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.6f} ms "
                      f"by {results[(path, name)]['bound_by']} ({moved} B, "
                      f"{ops} ops) ({card})")
        del captured

        # 5. small input: card (kernels) vs CPU (plain versions)
        spts, _ = make_building_cloud(**SMALL_SCENE)
        for path, cfg in (("default", PipelineConfig(knn_method="window")),
                          ("single_level", configs["single_level"])):
            small_gpu = segment_cloud(HostPointCloud(positions=spts), cfg,
                                      device="cuda")
            small_cpu = segment_cloud(HostPointCloud(positions=spts), cfg,
                                      device="cpu")
            cross = bij_agreement(small_cpu.plane_idx, small_gpu.plane_idx)
            if small_gpu.num_planes != small_cpu.num_planes or cross < 0.99:
                fail(f"small scene, {path}: card {small_gpu.num_planes} "
                     f"planes vs CPU {small_cpu.num_planes}, cross "
                     f"agreement {cross}")
            print(f"small scene ({len(spts)} points), {path}: card == CPU "
                  f"{small_cpu.num_planes} planes, cross agreement "
                  f"{cross:.4f}")

        # 6. the measured runs, one per path
        launches, summary = {}, {}
        for path in ("single_level", "default"):
            kernels.reset_launch_counts()
            out = segment_file(src, dst, configs[path], device="cuda")
            launches[path] = dict(kernels.launch_counts)
            want = KERNELS if path == "default" else SINGLE_LEVEL
            for name in want:
                if launches[path][name] == 0:
                    fail(f"{path} path never launched {name}")
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
                fail(f"output PLY has {back.count} points, expected "
                     f"{len(pts)}")
            labeled = out.plane_idx > 0
            colors = back.colors
            if not ((colors[labeled] >= 55).all()
                    and (colors[~labeled] == 0).all()):
                fail("output PLY colors do not follow the plane labels")
            if len(np.unique(colors[labeled], axis=0)) != out.num_planes:
                fail("output PLY does not hold one color per plane")
            if not np.isfinite(out.plane_normals).all():
                fail("non-finite plane normals")
            bij = bij_agreement(truth, out.plane_idx)
            planes, least = EXPECT[path]
            if out.num_planes != planes or bij < least:
                fail(f"{path}: {out.num_planes} planes at truth agreement "
                     f"{bij:.6f}; expected {planes} at >= {least}")
            summary[path] = {
                "planes": out.num_planes, "truth_bij": round(bij, 6),
                "num_sweeps": out.num_sweeps, "host_syncs": out.host_syncs,
                "diagnostics": out.diagnostics, "launches": launches[path],
                "stages_s": {k: round(v, 6) for k, v in out.timings.items()},
            }
            print(f"{path} path: {out.num_planes} planes at truth agreement "
                  f"{bij:.6f}, launches {launches[path]}")

        # stage times over three more default-path runs (min, max)
        runs = [segment_file(src, dst, DEFAULT_CONFIG, device="cuda").timings
                for _ in range(3)]
        spread = {k: [round(min(r[k] for r in runs), 6),
                      round(max(r[k] for r in runs), 6)] for k in runs[0]}

    print(json.dumps({"points": len(pts), "card": card, "build_s": t_build,
                      "paths": summary, "default_stages_min_max_s": spread}))
    rows = []
    for name, (src_file, replaces, _r, _pr) in KERNELS.items():
        r = results[("default", name)]
        rows.append({
            "name": name, "route": "cuda", "source": f"{SRC}/{src_file}",
            "replaces": f"{JAX_OPS}/{replaces}",
            "launches": launches["default"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
