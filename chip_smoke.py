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
   compact loop, refine, finalize), once under the single-level
   configuration ``seg_group=1``, once under ``knn_method="pallas"``
   (the exact-kNN path: kernel #14, gather normals, graph propagation)
   and once under the block-form variant path ``mxu``
   (``stats_rank_mode="mxu"``, ``seg_seed_mode="mxu"``: kernels #15 and
   #16 in place of #3 and #4), recording the inputs each path hands to
   every kernel wrapper;
4. hold each of the kernels the paths launch (the pair lookup, #9
   redesigned, and the fixed-order segment sums among them) against its
   plain PyTorch version on the inputs of every call the paths made — all
   must match bit for bit; for #2 the per-slot sums of its stats phase
   too (``stats_out`` against ``compact_slot_stats``) — and time both
   with CUDA events at the
   largest call, beside the kernel's bound (the bytes the function must
   move over 3.35 TB/s or the f32 operations it needs over 67 TFLOP/s,
   the H100 SXM's published peaks, counted from this run's data; #15
   and #16 compute the work of #3 and #4 and take their counts) and,
   for #14, one library call at the same shape (``torch.cdist`` +
   ``torch.topk`` over 4,096-query blocks: the expansion form, inexact,
   timing only); #15 and #3 are timed on the ``mxu`` path's stats input,
   #16 and #4 on its seed input, in turns (exact, block, block, exact);
   #16 is also held on its inputs with balls at or above 1e29, +inf and
   NaN on every sixth row (its full walk over all C candidates); #2's
   card ms by phase (``torch.profiler``, each launch of the sweep) over
   the default path's calls, beside each call's live slot bound; the
   segment sums over one pass of each path's calls, timed beside the
   accumulating ``index_put_`` they replace, with each call's longest
   live run and the bound (bytes over 3.35 TB/s, or the longest run's add
   chain at 4 cycles an add over the SM clock), their card ms, host ms
   and device launches a call; their order alone
   (``kernels.segment_order_cuda``, the hand-written stable sort of the
   live ids) held equal to its plain version on every call and timed
   beside ``torch.sort`` on the same keys and its bytes bound; the sums'
   card and host ms at the largest call on the default and pallas paths;
5. small-input check: the window configurations, the ``mxu`` path and
   the exact-kNN methods "brute" and "pallas" on a 9k-point scene on the
   card and on the CPU (plain versions) — same plane count, cross
   agreement ≥ 0.99;
6. the measured runs: for each path, launch counts reset, ``segment_file``
   on the slice's scene, counts read; every kernel of the path must have
   launched; the output PLY is re-read and checked; the default path
   gives 7 planes at truth agreement ≥ 0.9723 (the JAX package's
   0.982314 on this scene on the CPU, − 0.01), the single-level path
   8 planes at ≥ 0.9633 (0.9733 − 0.01), the pallas path 7 planes at
   ≥ 0.9853 (the JAX package's exact-kNN result, 0.995279 with "brute"
   on the CPU, − 0.01), the ``mxu`` path the default path's 7 planes at
   ≥ 0.9723 with cross agreement ≥ 0.99 against the default path's
   labels of this run, and #3 and #4 must not launch there; #9 must not
   launch on the default path (every finalize adopts holes: the pair
   lookup renumbers).  Three more
   runs of the default, pallas and ``mxu`` paths give their stage times;
7. ``DEFAULT_CONFIG`` on the same house at 105 mm spacing (60,914
   points): "auto" must resolve to "brute" and give 18 planes at truth
   agreement ≥ 0.6239 (JAX on the CPU: 0.633894 − 0.01), plus three
   runs of stage times; every segment-sum, hop and union call of its
   graph solve held and timed as in step 4;
8. the BASELINE config-2 shape: ``knn_pallas(k=16)`` on the house at
   25.4 mm spacing (1,046,391 points, capacity 1,046,528), Morton-sorted;
   the whole call and the kernel are timed, the kernel beside its bound
   and its tile count (listed, under the final tau, pairs a query), and
   32 sampled query tiles are held bit for bit against the plain version
   computed for those queries only (the whole plain run is O(N²));
9. the CLI as a subprocess: ``-a=scene.ply -s=out.ply --knn-method
   pallas --json-summary`` must exit 0 with the plane count of step 6;
   ``--render-dir R --extract-contours`` on the same scene must write the
   three PNGs, both contour overlays and a non-empty ``csa.obj``;
   ``--batch`` on a two-scan directory must exit 0;
10. the multi-scan render path at BASELINE config 5's size (the render
   path): four scans built as bench.py builds them (the house at 25 mm
   spacing, seeds 0-3, ~1.08M points each, capacity 1,179,648), written
   in metres, through ``segment_files(..., render_dir=...)`` under
   ``DEFAULT_CONFIG``: a warm-up run records every call of every kernel
   of the path (the default path's eight at this capacity and
   ``plane_sums``, kernel #8, the ground histogram), each held bit for
   bit against its plain version and timed beside its bound (#8 also
   beside ``index_add_``; #2 also by phase, as in step 4); then the measured run, with launch counts
   reset: every kernel of the default path and ``plane_sums`` once per
   scan must launch; no output keeps its positions on the card; each PLY
   reads back with its point count; each scan's labels and planes equal
   ``segment_cloud`` of the scan at the same capacity; each scan's
   directory holds the three PNGs; scan 0's card rasters (from the
   positions its ``segment_cloud`` run left on the card) equal its CPU
   rasters (plain versions, the same positions moved to the CPU) within
   the sums' reordering bound, and the PNGs agree within 1 per pixel.
   Its wall time gives the config-5 Mpts/s; ``render_ortho_views`` on
   scan 0 gives the render's own span.  #10 ``table_lookup_cols``, which
   no path calls, is held bit for bit against its plain version on the
   member ids and live bounds of the default path's ``table_lookup_pair``
   calls (slice scene and capacity 1,179,648) with a seeded f32[cap, 3]
   table, and timed at the largest (CUDA events, card ms, host ms; in
   step 4 also on the slice's inputs).  The redesigned kernels (#1, #2,
   #3, #4,
   #6, #11 and #13) are reported at both sizes: the slice scene's default
   path and config 5's scan 0 (#3, #4, #6, #11 and #13 at 1,179,648
   rows; #1 also on the single-level path); #6's line names its hole
   rows; #14 is reported on the pallas path and at the config-2 shape;
11. the ``mxu`` path at full size: config 5's scan 0 (1,082,304 points,
   capacity 1,179,648) through ``segment_file``: every #15 and #16 call
   held bit for bit (#16 also with the full-walk balls of step 4); #15 and #3 timed on the same captured stats input,
   #16 and #4 on the same captured seed input, as in step 4, beside the
   one bound of each pair; the labels agree with the default path's
   scan 0 of step 10 (cross agreement ≥ 0.99);
12. the reference's scene tests on the card at their own sizes
   (tests/test_scenes.py: a tilted plane, rolling terrain, a cylinder
   tank, a block of houses with clutter, through ``run_device_pipeline``
   under test_scenes.py's ``_run`` configuration; tests/
   test_multibuilding.py: two houses 40 m apart through
   ``segment_cloud``): each must launch the default path's eight kernels
   and give the JAX package's plane count on the CPU at a truth
   agreement ≥ the JAX package's − 0.01 (``SCENE_EXPECT``);
13. the multigrid ``heal`` switch at False and "merge" (the port's
   ``segment_planes_multigrid`` with the switch, under ``segment_file``):
   on the 9k-point scene card and CPU give the same planes at cross
   agreement ≥ 0.99 and truth agreement within 0.01; on the slice's
   scene #8 ``plane_sums`` launches once at False (the outermost
   finalize's sums) and never at "merge", #13 only at the inner level,
   #9 once (the outermost finalize adopts no holes) and the pair lookup
   once (the inner level), every #8 and #9 call held bit for bit
   against its plain version and timed beside its bound (card and host
   ms);
14. ``estimate_normals_window`` at bench.py's width: the house at 25 mm
   (1,082,304 points, capacity 1,083,392, Morton-sorted), radius 100,
   w = 64: #3 in radius-only mode (k = 1, no cap) launches once a call,
   is held bit for bit against its plain version and timed beside its
   bound; the normals are unit and finite; normals Mpts/s;
15. the CLI's ``--trace DIR`` (a Chrome trace holding the pipeline's
   stage spans and the card's kernels), ``--dump-stages F`` (the JAX
   package's keys) on the slice's scene, and ``--golden`` on the 9k-point
   scene (a PLY of its points), as subprocesses;
16. the native host codec (g++, built in step 2): on the slice's scene
   and on config 5's scan 0 ``write_ply`` writes the numpy codec's bytes
   and ``read_ply`` gives its arrays, both timed; the measured default
   runs of step 6 went through it (its call counts), their
   ``read_ply`` / ``write_ply`` / ``host_to_device`` printed beside the
   numpy codec's figures of the previous commit (``NUMPY_CODEC_MS``).

17. the sharded pipeline (``dist.sharded_pipeline``) on bench.py's
   scene (config 5's scan 0: 1,082,304 points, capacity 1,179,648),
   spawned at world 1 (NCCL, cuda:0) and world 2 (gloo, both ranks on
   the one card): world 1 equals the default one-device run
   (``run_device_pipeline``), world 2 the one-device run with
   ``seg_compact=False`` (the compact loop has no sharded form) and,
   under the ``mxu`` fields, the one-device ``mxu`` run with
   ``seg_compact=False``, bit for bit in labels, plane count and plane
   sizes; world 2 against the default run: the same plane count, cross
   agreement ≥ 0.99, truth agreement within 0.01.  Each rank records
   every kernel call of a warm-up run and holds it against its plain
   version on its own halo-padded inputs; in the measured run (counts set
   to 0 just before, read just after) every kernel of the path must
   launch on every rank.  Printed per rank: wall time and CUDA-event ms,
   sweeps, host syncs, reductions, gathers, halo bytes and messages (a
   sweep), host stagings, launch counts, and each rank's segment sums
   timed as in step 4.  Step 4 also gives the pair lookup's card ms
   beside an empty kernel's (the launch floor).

18. the graph solve's edge walk (``csrc/graph_hop.cu``, the hop and the
   union hook) at the exact cell's largest footprint (15 × 11 m, ~1.64M
   points, "pallas" through ``segment_file``): every call held bit for
   bit against its plain version, timed beside its bytes bound and the
   plain version (its largest call and a pass of all its calls), and the
   launch counts (the hop ``GRAPH_HOPS`` times a sweep, the union once a
   sweep); steps 4 and 7 hold and time it on the pallas and auto (brute)
   paths.

The last three lines of stdout are the card line, the kernels' JSON
record and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SCENE = dict(seed=0, spacing_mm=55.0, width_mm=12000.0, depth_mm=9000.0,
             wall_h_mm=6000.0, ridge_h_mm=8000.0, noise_mm=8.0)
SCENE_POINTS = 222828
SMALL_SCENE = dict(seed=5, spacing_mm=120.0, width_mm=5000.0,
                   depth_mm=4000.0, wall_h_mm=3000.0, ridge_h_mm=4000.0)
# the same house at 105 mm spacing: "auto" resolves to "brute" there
AUTO_SCENE = dict(SCENE, spacing_mm=105.0)
AUTO_POINTS = 60914
# the BASELINE config-2 shape (~1M rows): the house at 25.4 mm spacing
CONFIG2_SCENE = dict(SCENE, spacing_mm=25.4)
CONFIG2_POINTS = 1046391
# BASELINE config 5: four scans as bench.py builds them (seeds 0-3)
MULTISCAN_SCENE = dict(SCENE, spacing_mm=25.0)
MULTISCAN_SCANS = 4
MULTISCAN_CAPACITY = 1179648
RENDER_PNGS = ("平均高度.png", "像素数量.png", "像素数量+高度.png")
# (planes, least truth agreement) per path: the JAX package's CPU result
# on its scene, agreement − 0.01
EXPECT = {"default": (7, 0.9723), "single_level": (8, 0.9633),
          "pallas": (7, 0.9853), "auto": (18, 0.6239), "mxu": (7, 0.9723)}
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# cycles of one dependent f32 add: the fixed-order sums' chain bound
F32_ADD_CYCLES = 4
SRC = "buildingsegment_tpu_torch/csrc"
JAX_PKG = "buildingsegment_tpu"
# kernel → (CUDA source, the TPU kernel it replaces, timing reps for the
# kernel and for its plain version); the segment sums replace the JAX
# package's XLA scatter-adds, no TPU kernel
KERNELS = {
    "stats_sweep": ("stats_sweep.cu", "ops/stats_sweep.py:100", 50, 3),
    "seed_sweep": ("seed_sweep.cu", "ops/window_sweep.py:519", 50, 3),
    "label_sweep": ("label_sweep.cu", "ops/window_sweep.py:731", 50, 5),
    "compact_sweep": ("compact_sweep.cu", "ops/compact_sweep.py:100", 20, 3),
    "refine_sweep": ("refine_sweep.cu", "ops/window_sweep.py:332", 50, 3),
    "payload_moment_sums": ("segsum.cu", "ops/segsum.py:315", 50, 3),
    "table_lookup": ("segsum.cu", "ops/segsum.py:141", 50, 5),
    "table_lookup_pair": ("segsum.cu", "ops/segsum.py:141", 50, 5),
    "plane_adopt": ("adopt.cu", "ops/adopt.py:87", 50, 3),
    "knn_exact": ("knn_exact.cu", "ops/pallas_knn.py:95", 20, 1),
    "plane_sums": ("segsum.cu", "ops/segsum.py:41", 50, 3),
    "stats_mxu": ("stats_mxu.cu", "ops/stats_mxu.py:75", 20, 1),
    "seed_mxu": ("stats_mxu.cu", "ops/stats_mxu.py:262", 50, 1),
    "table_lookup_cols": ("segsum.cu", "ops/segsum.py:222", 50, 5),
    "segment_sums": ("segment_sum.cu", "seg/region_grow.py:453", 20, 3),
    "graph_hop": ("graph_hop.cu", "seg/region_grow.py:528", 50, 5),
    "graph_union": ("graph_hop.cu", "seg/region_grow.py:653", 50, 5),
}
# the kernels each path must launch
PATH_KERNELS = {
    "default": ("stats_sweep", "seed_sweep", "label_sweep", "compact_sweep",
                "refine_sweep", "payload_moment_sums", "table_lookup_pair",
                "plane_adopt", "segment_sums"),
    "single_level": ("label_sweep", "compact_sweep", "segment_sums"),
    "pallas": ("knn_exact", "segment_sums", "graph_hop", "graph_union"),
}
# the block-form variant path: #15 and #16 in place of #3 and #4
PATH_KERNELS["mxu"] = ("stats_mxu", "seed_mxu") + PATH_KERNELS["default"][2:]
MXU_REPLACES = {"stats_mxu": "stats_sweep", "seed_mxu": "seed_sweep"}
# the multi-scan render path runs the default path and the raster
PATH_KERNELS["render"] = PATH_KERNELS["default"] + ("plane_sums",)
# the path whose calls and launches each kernel reports (#10 has no
# caller: it is held on the render path's lookup inputs; #9 serves the
# finalizes that adopt no holes, as at heal=False)
MAIN_PATH = {name: path for path in ("single_level", "pallas", "default")
             for name in PATH_KERNELS[path]}
MAIN_PATH.update(plane_sums="render", stats_mxu="mxu", seed_mxu="mxu",
                 table_lookup_cols="render", table_lookup="heal_false")
# the wrapper argument whose length is the call's row count
ROWS_ARG = {"stats_sweep": 1, "seed_sweep": 2, "label_sweep": 4,
            "compact_sweep": 4, "refine_sweep": 2, "payload_moment_sums": 0,
            "table_lookup": 0, "plane_adopt": 1, "knn_exact": 1,
            "plane_sums": 0, "stats_mxu": 1, "seed_mxu": 2,
            "table_lookup_cols": 0, "table_lookup_pair": 0,
            "segment_sums": 0, "graph_hop": 0, "graph_union": 0}
# the graph solve's edge walk: the hop and the union hook
GRAPH_WALKS = ("graph_hop", "graph_union")
# the exact cell's largest footprint (benchmark/configs/
# tls_house_25mm_exact.json, seed 0): the graph walk's largest shape
EXACT_LARGEST_SCENE = dict(seed=0, spacing_mm=25.0, noise_mm=8.0,
                           width_mm=15000.0, depth_mm=11000.0,
                           wall_h_mm=7000.0, ridge_h_mm=9500.0)
# the seeded table of the #10 check: f32[cap, LOOKUP_COLS]
LOOKUP_COLS = 3
# balls of #16's full walk, on every sixth row of its held inputs: the
# 1e29 cut, above it, +inf and NaN (and a negative one)
FULL_WALK_BALLS = (1e29, 5e29, 2e30, float("inf"), float("nan"), -1.0)
# tests/test_scenes.py's scenes and the configuration of its _run; the
# two houses of tests/test_multibuilding.py (segment_cloud, their config)
SCENE_RUN = dict(
    k_search=50, knn_k=15, normal_radius=100.0, normal_max_nn=50,
    th_thickness=300.0, th_normal_cos=0.88, th_point_count=400,
    max_planes=4096, max_sweeps=64, knn_method="window",
    knn_window_size=64, convergence_tol=1e-5, seg_group=4, seg_levels=2,
    seg_refine_sweeps=3)
SCENES = {
    "tilted_plane": ("make_terrain_cloud", dict(
        seed=3, extent_mm=10_000.0, spacing_mm=50.0, slope=0.15)),
    "rolling_terrain": ("make_terrain_cloud", dict(
        seed=3, extent_mm=10_000.0, spacing_mm=50.0, slope=0.05,
        roll_amp_mm=400.0, roll_period_mm=4_000.0)),
    "cylinder_tank": ("make_cylinder_cloud", dict(
        seed=2, spacing_mm=50.0, ground_extent_mm=8_000.0)),
    "block_clutter": ("make_block_cloud", dict(
        seed=4, nx=2, ny=1, spacing_mm=80.0, clutter_frac=0.1)),
}
TWO_HOUSES_CONFIG = dict(normal_radius=500.0, pad_to_multiple=2048,
                         knn_method="window")
# (points, planes, truth agreement) of the JAX package on the CPU, from
# JAX_PLATFORMS=cpu python -m pytest -q -s -m slow tests/test_torch_scenes.py
SCENE_EXPECT = {
    "tilted_plane": (40000, 1, 0.998625),
    "rolling_terrain": (40000, 13, 0.442250),
    "cylinder_tank": (59416, 8, 0.427831),
    "block_clutter": (110720, 12, 0.931765),
    "two_houses": (60608, 16, 0.933458),
}
# the stage spans the window path's run puts in a --trace
TRACE_SPANS = ("stage1", "segmentation", "unsort", "device_to_host",
               "colorize")
# the keys of the JAX package's --dump-stages file
DUMP_KEYS = ("positions", "plane_idx", "plane_normals", "plane_centers",
             "plane_counts", "bbox_min", "num_planes")
# the default path's host stages with the numpy codec at the previous
# commit (ms, min–max of three runs, NVIDIA H100 80GB HBM3, 700.00 W;
# its read_ply was not recorded)
NUMPY_CODEC_MS = {"write_ply": (15.9, 18.8), "host_to_device": (24.9, 27.8),
                  "total_with_io": (91.4, 115.1)}


def mxu_config(**kw):
    """The block-form variant path: DEFAULT_CONFIG with the "mxu" stats
    and seed sweeps."""
    from buildingsegment_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig(stats_rank_mode="mxu", seg_seed_mode="mxu", **kw)


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


def card_ms(torch, fn, reps=20):
    """Device milliseconds a call of ``fn``: the kernels' time in a
    ``torch.profiler`` trace of ``reps`` calls (after one warm-up), None
    where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and "CUDA" in str(e.device_type):
            total += us
    return total / 1e3 / reps if total else None


def host_ms(torch, fn, reps=50):
    """Host milliseconds to issue a call of ``fn``: ``reps`` calls with no
    synchronise between them (after one warm-up), over ``reps``."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def timed_row(torch, name, row, calls, cuda_fn, where, card):
    """Add the profiler's card ms and the host issue ms of the first call
    at the largest row count to a kernel's row, and print them."""
    big = max(n for n, _a, _k in calls)
    _n, args, kw = next(c for c in calls if c[0] == big)
    row["card_ms"] = card_ms(torch, lambda: cuda_fn(*args, **kw))
    row["host_ms"] = host_ms(torch, lambda: cuda_fn(*args, **kw))
    print(f"{name} ({where}, {big} rows): card ms {row['card_ms']} a call "
          f"(profiler), host ms {row['host_ms']:.4f}, bound "
          f"{row['bound_ms']:.6f} ms ({card})")
    return row


@functools.lru_cache(maxsize=None)
def sm_clock_hz():
    """The card's largest SM clock (nvidia-smi), Hz."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    try:
        return float(res.stdout.strip().splitlines()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {res.stdout!r} {res.stderr!r}")


def segment_runs(torch, args):
    """(live rows, the longest live run) of one ``segment_sums`` call: the
    rows whose id lies in [0, size), and the most rows of one id."""
    idx, _rows, size, _init = args
    live = idx[(idx >= 0) & (idx < size)]
    if live.numel() == 0:
        return 0, 0
    return int(live.numel()), int(torch.bincount(live.long()).max())


def index_put_call(torch, args):
    """The yardstick of the segment sums: the call the port made before
    (``row_order_sums`` on the card), one accumulating ``index_put_`` of
    the rows into a zeroed table with a row for the ids outside the
    table (the callers' dump id), ``init``'s rows first — made ready
    here, so the returned callable times the fill and the call alone."""
    idx, rows, size, init = args
    ids = torch.where((idx >= 0) & (idx < size), idx, size).long()
    if init is not None:
        ids = torch.cat([torch.arange(size, device=ids.device), ids])
        rows = torch.cat([init, rows])

    def run():
        return torch.zeros((size + 1, rows.shape[1]), dtype=rows.dtype,
                           device=rows.device).index_put_(
            (ids,), rows, accumulate=True)
    return run


def card_launches(torch, fn, reps=3):
    """Device activities (kernels, memsets, copies) a call of ``fn`` in a
    ``torch.profiler`` trace of ``reps`` calls, after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "CUDA" in str(e.device_type)) / reps


def segment_sums_record(torch, where, calls, card, reps=3):
    """The segment sums on one path's captured calls: each call's live
    rows and longest live run; the bounds (bytes over 3.35 TB/s; the
    longest run's add chain at 4 cycles an add over the SM clock) summed
    over the calls; the order alone (``kernels.segment_order_cuda``) held
    equal to its plain version on every call; the kernel, the order alone,
    ``torch.sort`` on the same keys (dead rows keyed ``size``: the
    library call the order replaces) and the accumulating ``index_put_``
    the sums replace, each timed over one pass of all the calls (CUDA
    events); the sums' and the order's card ms a pass (profiler), host ms
    and device launches a call.  Printed; returns the record."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.ops.segsum import segment_order_reference

    clock = sm_clock_hz()
    per, keys, lib, orders = [], [], [], []
    t_bytes = t_chain = t_order = 0.0
    for n, args, kw in calls:
        out = kernels.segment_sums_cuda(*args, **kw)
        moved, _ops, _note = work(torch, "segment_sums", args, kw, out)
        live, longest = segment_runs(torch, args)
        per.append([n, args[1].shape[1], live, longest])
        t_bytes += moved / HBM_BYTES_PER_S * 1e3
        t_chain += longest * F32_ADD_CYCLES / clock * 1e3
        idx, _rows, size, _init = args
        perm, start, end = kernels.segment_order_cuda(idx, size)
        want = segment_order_reference(idx, size)
        if not all(torch.equal(a, b) for a, b in
                   zip((perm[:live], start, end), want)):
            fail(f"segment order ({where}, {n} rows, size {size}): kernel "
                 f"!= plain version")
        # the order's bytes: the ids read once, the live rows' indices
        # and every id's run bounds written once
        t_order += (idx.numel() * idx.element_size() + 4 * live
                    + 8 * size) / HBM_BYTES_PER_S * 1e3
        orders.append((idx, size))
        keys.append(torch.where((idx >= 0) & (idx < size), idx, size).int())
        lib.append(index_put_call(torch, args))

    def sums_pass():
        for _n, a, k in calls:
            kernels.segment_sums_cuda(*a, **k)

    def order_pass():
        for i, s in orders:
            kernels.segment_order_cuda(i, s)

    ms = cuda_ms(torch, sums_pass, reps)
    order_ms = cuda_ms(torch, order_pass, reps)
    sort_ms = cuda_ms(torch, lambda: [torch.sort(k, stable=True)
                                      for k in keys], reps)
    lib_ms = cuda_ms(torch, lambda: [f() for f in lib], reps)
    rec = {"calls": len(calls), "rows_cols_live_longest": per, "ms": ms,
           "card_ms": card_ms(torch, sums_pass, reps),
           "host_ms_a_call": host_ms(torch, sums_pass, reps) / len(calls),
           "launches_a_call": card_launches(torch, sums_pass) / len(calls),
           "order_ms": order_ms, "order_card_ms": card_ms(torch, order_pass,
                                                          reps),
           "order_host_ms_a_call": host_ms(torch, order_pass,
                                           reps) / len(calls),
           "order_launches_a_call": card_launches(torch,
                                                  order_pass) / len(calls),
           "order_bound_ms": t_order, "sort_ms": sort_ms,
           "index_put_ms": lib_ms,
           "bytes_bound_ms": t_bytes, "chain_bound_ms": t_chain,
           "bound_ms": max(t_bytes, t_chain), "sm_clock_hz": clock}
    longest = max((p[3] for p in per), default=0)
    print(f"segment_sums ({where}): {len(calls)} calls, rows "
          f"{sorted({p[0] for p in per})}, cols {sorted({p[1] for p in per})}"
          f", longest live run a call {[p[3] for p in per]}; the order == "
          f"plain on each; one pass: kernel {ms:.4f} ms (card "
          f"{rec['card_ms']}, host {rec['host_ms_a_call']:.4f} a call, "
          f"{rec['launches_a_call']:.2f} launches a call) vs accumulating "
          f"index_put_ {lib_ms:.4f} ms; its order alone {order_ms:.4f} ms "
          f"(card {rec['order_card_ms']}, host "
          f"{rec['order_host_ms_a_call']:.4f} a call, "
          f"{rec['order_launches_a_call']:.2f} launches a call, bound "
          f"{t_order:.6f}) vs torch.sort on the same keys {sort_ms:.4f} ms; "
          f"bound {rec['bound_ms']:.6f} ms (bytes {t_bytes:.6f}, chain "
          f"{t_chain:.6f}: longest run {longest} x {F32_ADD_CYCLES} cycles "
          f"at {clock / 1e6:.0f} MHz) ({card})")
    return rec


def window_pairs(torch, mask, w):
    """Valid (row, candidate) pairs of a ±w window: the candidate tests a
    window kernel must make on these inputs."""
    m = mask.to(torch.int64)
    c = torch.cumsum(torch.cat([m.new_zeros(1), m]), 0)
    n = m.shape[0]
    i = torch.arange(n, device=m.device)
    lo, hi = (i - w).clamp(0, n), (i + w + 1).clamp(0, n)
    return int(((c[hi] - c[lo] - m) * m).sum())


def knn_tiles(torch, args, kw, out_d):
    """(query-candidate pairs an exact scan by tiles must test on these
    inputs, candidate tiles ``counts`` lists, tiles it must visit) of one
    ``knn_exact`` call.  A query tile must visit the listed tiles whose box
    bound is at or below its final τ, the largest kept k-th distance over
    its valid rows: a tile above it cannot hold a member of any row's
    result.  In those tiles each valid query meets each valid candidate
    outside its rank window |c − q| ≤ w_excl (self included)."""
    pos, visit, visit_d2, counts = args[0], args[3], args[4], args[5]
    qt, ct, w = kw["qt"], kw["ct"], kw["w_excl"]
    valid = pos[0] > -1e7
    n = valid.shape[0]
    num_q, num_c = n // qt, n // ct
    vq = valid.reshape(num_q, qt)
    tau = torch.where(vq, out_d[:, -1].reshape(num_q, qt), -1.0).amax(1)
    need = visit_d2 <= tau[:, None]  # a prefix: the list is sorted
    # the same by candidate tile id
    seen = torch.zeros_like(need).scatter_(1, visit.long(), need)
    nvc = valid.reshape(num_c, ct).sum(1)
    pairs = int((vq.sum(1) * (seen * nvc[None]).sum(1)).sum())
    # less the rank-window pairs in the tiles visited: the window of row
    # q spans at most 2·w // ct + 2 candidate tiles
    csum = torch.cumsum(torch.cat([valid.new_zeros(1, dtype=torch.int64),
                                   valid.long()]), 0)
    q = torch.arange(n, device=valid.device)
    lo, hi = (q - w).clamp(min=0), (q + w).clamp(max=n - 1)
    for off in range(2 * w // ct + 2):
        t = lo // ct + off
        a = torch.maximum(lo, t * ct)
        b = torch.minimum(hi, t * ct + ct - 1)
        inside = (a <= b) & valid & seen[q // qt, t.clamp(max=num_c - 1)]
        cnt = csum[b + 1] - csum[a.clamp(max=n)]
        pairs -= int(torch.where(inside, cnt, 0).sum())
    return pairs, int(counts.sum()), int(need.sum())


def work(torch, name, args, kw, out):
    """(bytes each input read once and each output written once, f32
    operations these inputs need, a note) of one wrapper call.  Where the
    function reads only some rows of an input (the payload of live or
    hole rows), only those count."""
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
    note = ""
    # the block-form sweeps compute the exact sweeps' function
    name = MXU_REPLACES.get(name, name)
    if name == "stats_sweep":
        mask = args[1]
        pairs = window_pairs(torch, mask, kw["w"])
        used = float((out[1] - mask.float()).sum())
        # the order statistics the call selects: the k-th NN (k > 1) and
        # the hybrid cap (max_nn − 1 < 2w); radius-only mode has neither
        stats = int(kw["k"] > 1) + int(
            kw["max_nn"] is not None and kw["max_nn"] - 1 < 2 * kw["w"])
        # per pair: d² (8), the radius ∩ cap test (1) and one compare for
        # each order statistic (a selection must look at every candidate
        # once); per neighbour used: the moments (19)
        ops = pairs * (8 + 1 + stats) + used * 19
    elif name == "seed_sweep":
        # by unordered pairs (the tests are symmetric up to the ball and
        # the normal): d² (8) and the cos with its compare (6) once a
        # pair; each direction's ball compare (1) and plane band (6)
        ordered = window_pairs(torch, args[2], kw["w"])
        ops = ordered // 2 * (8 + 6) + ordered * (1 + 6)
    elif name in ("label_sweep", "compact_sweep"):
        mask = args[5] if name == "label_sweep" else args[3]
        ops = window_pairs(torch, mask, kw["w"]) * 40
        if name == "compact_sweep":
            ops += args[6] * args[6] * 40 + mask.shape[0] * 16
    elif name == "refine_sweep":
        pid_in, mask = args[3], args[2]
        # hole rows: valid, no kept plane (none, or dropped by `clean`:
        # a row its own plane rejects cannot adopt that plane again)
        holes = mask & ((pid_in <= 0) | (out != pid_in))
        adopting = int(holes.sum()) if kw.get("adopt", True) else 0
        ops = int(mask.sum()) * 12 + adopting * 2 * kw["w"] * 30
        note = f"; {adopting} hole rows of {mask.shape[0]}"
    elif name == "payload_moment_sums":
        ids, payload = args[0], args[1]
        live_bound = -(-args[3] // 128) * 128  # the kernel's live-id bound
        live = int(((ids >= 0) & (ids < live_bound)).sum())
        # the payload is read for live rows only
        moved -= (ids.shape[0] - live) * payload.shape[1] * 4
        ops = live * 23
    elif name in ("table_lookup", "table_lookup_cols", "table_lookup_pair"):
        ops = 0
    elif name == "segment_sums":
        idx, rows = args[0], args[1]
        live, longest = segment_runs(torch, args)
        # the rows are read for live rows only; one add a live element
        moved -= (idx.shape[0] - live) * rows.shape[1] * 4
        ops = live * rows.shape[1]
        note = (f"; {live} live rows of {idx.shape[0]}, longest run "
                f"{longest}")
    elif name == "plane_sums":
        ids, payload = args[0], args[1]
        live_bound = min(-(-args[2] // 128), -(-kw["table_cap"] // 128)) * 128
        live = int(((ids >= 0) & (ids < live_bound)).sum())
        # the payload is read for live rows only; one add a live element
        moved -= (ids.shape[0] - live) * payload.shape[1] * 4
        ops = live * payload.shape[1]
        note = f"; {live} live rows of {ids.shape[0]}"
    elif name == "knn_exact":
        # per pair an exact scan must test: d² (8) and one compare; the
        # kernel's own list rescans are not the function's work
        pairs, listed, needed = knn_tiles(torch, args, kw, out[0])
        ops = pairs * 9
        valid_q = int((args[0][0] > -1e7).sum())
        note = (f"; candidate tiles: {listed} listed, {needed} under the "
                f"final tau; {pairs} pairs, {pairs / max(valid_q, 1):.1f} "
                f"a valid query")
    elif name in GRAPH_WALKS:
        label, nb, nb_valid, models = (*args[:3], args[-1])
        ng = models.shape[0]
        n_live = int(torch.unique(label[label < ng]).numel())
        lab_t = label[nb.long()]
        differ = nb_valid & (lab_t != label[:, None])
        if name == "graph_union":
            differ &= (label[:, None] < ng) & (lab_t < ng)
        edges = int(differ.sum())
        # read once: labels, ids, validity bytes, each live label's model
        # (24 B) and, for the hop, each point's position and normal (24
        # B); written: out or parent.  Per valid edge whose two labels
        # differ one gate (17: 9 for the band, 6 for the cos, 2 compares),
        # two for the union
        moved = (label.numel() * 4 + nb.numel() * 4 + nb_valid.numel()
                 + n_live * 24 + out.numel() * 4)
        if name == "graph_hop":
            moved += label.numel() * 24
        ops = edges * (17 if name == "graph_hop" else 34)
        note = (f"; {int(nb_valid.sum())} valid edges, {edges} with two "
                f"labels, {n_live} live labels")
    else:  # plane_adopt
        payload, holes, table = args[0], args[1], args[2]
        nh = int(holes.sum())
        # the payload is read for hole rows only
        moved -= (holes.shape[0] - nh) * payload.shape[1] * 4
        ok_lanes = int((table[9] > 0).sum())
        # per (hole, ok lane): three dots and the three gates (24); per
        # adopted row: its payload added to its lane (8)
        ops = nh * ok_lanes * 24 + int(out[0].sum()) * 8
    return moved, ops, note


def knn_library_ms(torch, args, kw, reps=2):
    """The yardstick of #14: ``torch.cdist`` + ``torch.topk`` over
    4,096-query blocks on the same positions and k (the expansion form:
    inexact, never used by the port)."""
    p = torch.stack(list(args[0]), 1)
    kk = args[1].shape[1]

    def run():
        for q0 in range(0, p.shape[0], 4096):
            torch.cdist(p[q0:q0 + 4096], p).topk(kk + 1, largest=False)
    return cuda_ms(torch, run, reps)


def segsum_library_ms(torch, args, kw, reps=50):
    """The yardstick of #8: one ``index_add_`` of the payload rows into a
    zeroed table.  It computes the same function only where every id lies
    inside the live bound (the histogram's ids do); else None."""
    ids, payload, n_live = args
    cap128 = -(-kw["table_cap"] // 128) * 128
    bound = min(-(-n_live // 128) * 128, cap128)
    if not bool(((ids >= 0) & (ids < bound)).all()):
        return None

    def run():
        torch.zeros((cap128, payload.shape[1]), dtype=torch.float32,
                    device=ids.device).index_add_(0, ids, payload)
    return cuda_ms(torch, run, reps)


def max_abs_err(torch, k_t, p_t):
    """Largest |kernel − plain| over the outputs (equal values, +inf
    included, count 0)."""
    return max(float(torch.where(a == b, 0.0, (a.float() - b.float()).abs())
                     .max()) for a, b in zip(k_t, p_t))


def check_output_ply(np, read_ply, dst, out, n_points):
    """The labeled PLY as the reference writes it: binary, one color per
    plane, unlabeled points black."""
    with open(dst, "rb") as f:
        head = f.read(1024).split(b"end_header")[0].decode()
    for line in ("format binary_little_endian 1.0",
                 f"element vertex {n_points}",
                 "property uchar green", "property uchar blue",
                 "property uchar red"):
        if line not in head:
            fail(f"output PLY header lacks {line!r}")
    back = read_ply(dst)
    if back.count != n_points:
        fail(f"output PLY has {back.count} points, expected {n_points}")
    labeled = out.plane_idx > 0
    colors = back.colors
    if not ((colors[labeled] >= 55).all() and (colors[~labeled] == 0).all()):
        fail("output PLY colors do not follow the plane labels")
    if len(np.unique(colors[labeled], axis=0)) != out.num_planes:
        fail("output PLY does not hold one color per plane")
    if not np.isfinite(out.plane_normals).all():
        fail("non-finite plane normals")


def stage_spread(runs):
    """(min, max) seconds of every stage over the runs' timings."""
    return {k: [round(min(r[k] for r in runs), 6),
                round(max(r[k] for r in runs), 6)] for k in runs[0]}


def clone(torch, x):
    """A copy of a wrapper's arguments, so later in-place updates on the
    path do not change what the kernel check sees."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(torch, v) for v in x)
    return x


@contextlib.contextmanager
def spying(torch, hooks, seen):
    """Within the block, every call of a hooked wrapper appends (rows, a
    copy of its arguments, its keywords but the shard ``group``, which
    only the wrapper reads) to ``seen[name]`` (list appends are atomic,
    so the multi-scan writer thread may call too)."""
    def spy(name, fn):
        def call(*args, **kw):
            n = args[ROWS_ARG[name]].shape[0]
            seen.setdefault(name, []).append(
                (n, clone(torch, args),
                 {k: v for k, v in kw.items() if k != "group"}))
            return fn(*args, **kw)
        return call

    orig = {k: getattr(mod, attr) for k, (mod, attr, _) in hooks.items()}
    for k, (mod, attr, _) in hooks.items():
        setattr(mod, attr, spy(k, orig[k]))
    try:
        yield
    finally:
        for k, (mod, attr, _) in hooks.items():
            setattr(mod, attr, orig[k])


def with_slot_stats(torch, cuda_fn, plain_fn):
    """#2's pair for the bit-for-bit check: the sweep's outputs and the
    per-slot sums of its stats phase, the kernel's (``stats_out``) and the
    plain version's (``compact_slot_stats``)."""
    from buildingsegment_tpu_torch.ops.compact_sweep import compact_slot_stats

    def cuda(*args, **kw):
        stats = torch.empty((kw["lc"], 16), dtype=torch.float32,
                            device=args[4].device)
        return (*cuda_fn(*args, stats_out=stats, **kw), stats)

    def plain(*args, **kw):
        pos, _nrm, cnrm, _mask, clab, anchor, bound = args
        stats = compact_slot_stats(
            pos, cnrm, clab, anchor, bound, lc=kw["lc"], w=kw["w"],
            th_anchor_cos=kw["th_anchor_cos"], anchor_gate=kw["anchor_gate"],
            signed=kw.get("signed", False))
        return (*plain_fn(*args, **kw), stats)
    return cuda, plain


def hold_calls(torch, name, path, calls, cuda_fn, plain_fn):
    """Every captured call of one kernel against its plain version, bit for
    bit; returns the largest |kernel − plain| (0.0)."""
    if name == "compact_sweep":
        cuda_fn, plain_fn = with_slot_stats(torch, cuda_fn, plain_fn)
    err = 0.0
    for n, args, kw in calls:
        k_out = cuda_fn(*args, **kw)
        p_out = plain_fn(*args, **kw)
        torch.cuda.synchronize()
        k_t = k_out if isinstance(k_out, tuple) else (k_out,)
        p_t = p_out if isinstance(p_out, tuple) else (p_out,)
        e = max_abs_err(torch, k_t, p_t)
        if not all(torch.equal(a, b) for a, b in zip(k_t, p_t)):
            fail(f"{name} ({path} path, {n} rows, kw {kw}): "
                 f"kernel != plain version (max abs err {e})")
        err = max(err, e)
    return err


def hold_kernel(torch, name, path, calls, cuda_fn, plain_fn, card):
    """Every captured call of one kernel against its plain version, bit for
    bit; the first call at the largest row count timed beside its bound
    and, where there is one, the library call.  Returns the kernel's row."""
    err = hold_calls(torch, name, path, calls, cuda_fn, plain_fn)
    big = max(n for n, _a, _k in calls)
    n, args, kw = next(c for c in calls if c[0] == big)
    k_out = cuda_fn(*args, **kw)
    reps, plain_reps = KERNELS[name][2:]
    ms = cuda_ms(torch, lambda: cuda_fn(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: plain_fn(*args, **kw), plain_reps)
    moved, ops, note = work(torch, name, args, kw, k_out)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    if name == "knn_exact":
        library_ms = knn_library_ms(torch, args, kw)
    elif name == "plane_sums":
        library_ms = segsum_library_ms(torch, args, kw)
    elif name == "segment_sums":
        library_ms = cuda_ms(torch, index_put_call(torch, args), plain_reps)
    else:
        library_ms = None
    row = dict(rows=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=library_ms)
    print(f"{name} ({path} path): {len(calls)} calls, kernel == plain on "
          f"each; rows={n}: {ms:.4f} ms vs plain {plain_ms:.4f} ms, library "
          f"{library_ms} ms, bound {row['bound_ms']:.6f} ms by "
          f"{row['bound_by']} ({moved} B, {ops} ops{note}) ({card})")
    return row


def block_vs_exact(torch, name, calls, cuda_fns, card, where):
    """#15 (#16) and the exact kernel it stands in for, #3 (#4), timed on
    the same captured input (the first call at the largest row count) in
    turns — exact, block, block, exact — beside the one bound of the
    function both compute.  Returns the pair's record."""
    exact = MXU_REPLACES[name]
    big = max(n for n, _a, _k in calls)
    n, args, kw = next(c for c in calls if c[0] == big)
    block_fn, exact_fn = cuda_fns[name], cuda_fns[exact]
    reps = KERNELS[name][2]
    t_exact = [cuda_ms(torch, lambda: exact_fn(*args, **kw), reps)]
    t_block = [cuda_ms(torch, lambda: block_fn(*args, **kw), reps)
               for _ in range(2)]
    t_exact.append(cuda_ms(torch, lambda: exact_fn(*args, **kw), reps))
    moved, ops, _note = work(torch, exact, args, kw, exact_fn(*args, **kw))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    rec = {"rows": n, "calls": len(calls), "ms": t_block,
           f"{exact}_ms": t_exact, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"{name} vs {exact} on the same input, {n} rows ({where}): "
          f"{name} {t_block[0]:.4f} / {t_block[1]:.4f} ms, {exact} "
          f"{t_exact[0]:.4f} / {t_exact[1]:.4f} ms, bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']} ({card})")
    return rec


def lookup_cols_calls(torch, calls, seed):
    """#10's inputs from captured ``table_lookup_pair`` calls: the same
    member ids and live bound, with a seeded f32[cap, LOOKUP_COLS]
    table."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for n, (ids, lut, _ids_b, _lut_b, n_live), _kw in calls:
        table = torch.randn((lut.shape[0], LOOKUP_COLS), generator=g)
        out.append((n, (ids, table.to(ids.device), n_live), {}))
    return out


def full_walk_calls(torch, calls):
    """#16's captured inputs with the balls of ``FULL_WALK_BALLS`` on every
    sixth row: the kernel walks all C candidates for those rows."""
    out = []
    for n, (pos, nrm, mask, dk), kw in calls:
        rows = torch.arange(n, device=dk.device)
        balls = torch.tensor(FULL_WALK_BALLS, device=dk.device)
        dk = torch.where(rows % 6 == 0, balls[(rows // 6) % len(balls)], dk)
        out.append((n, (pos, nrm, mask, dk), kw))
    return out


def hold_full_walk(torch, path, calls, cuda_fn, plain_fn):
    """#16 held bit for bit on its captured calls with full-walk balls."""
    err = hold_calls(torch, "seed_mxu", f"{path}, full walk",
                     full_walk_calls(torch, calls), cuda_fn, plain_fn)
    print(f"seed_mxu ({path} path) with balls {FULL_WALK_BALLS} on every "
          f"sixth row: {len(calls)} calls, kernel == plain on each")
    return err


def compact_phases(torch, calls, card, where, reps=20):
    """#2's card ms by launch (its six phases and the counters' memset)
    over one pass of the captured calls, from ``torch.profiler``, with
    each call's live slot bound.  Printed; returns the record."""
    from torch.profiler import ProfilerActivity, profile

    from buildingsegment_tpu_torch import kernels

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for _n, args, kw in calls:
                kernels.compact_sweep_cuda(*args, **kw)
        torch.cuda.synchronize()
    phases = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and "CUDA" in str(e.device_type):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].replace("void ", "").strip()
            phases[name] = phases.get(name, 0.0) + us / 1e3 / reps
    bounds = [int(args[6]) for _n, args, _kw in calls]
    # the pair phase tests bound² ordered pairs, the hop phase each valid
    # (row, window candidate) pair, ~40 f32 operations each
    pair_ops = sum(b * b * 40 for b in bounds)
    hop_ops = sum(window_pairs(torch, args[3], kw["w"]) * 40
                  for _n, args, kw in calls)
    rec = {"calls": len(calls), "rows": sorted({n for n, _a, _k in calls}),
           "bounds": bounds, "card_ms_by_phase": phases or None,
           "pairs_bound_ms": pair_ops / F32_OPS_PER_S * 1e3,
           "hop_bound_ms": hop_ops / F32_OPS_PER_S * 1e3}
    shown = (", ".join(f"{k} {v:.5f}" for k, v in sorted(
        phases.items(), key=lambda kv: -kv[1])) if phases
        else "not measured (the profiler recorded no device time)")
    print(f"compact_sweep by phase ({where}: {len(calls)} calls, rows "
          f"{rec['rows']}, live bounds {bounds}), card ms a run: {shown}; "
          f"bounds a run: pairs {rec['pairs_bound_ms']:.6f} ms, hop "
          f"{rec['hop_bound_ms']:.6f} ms (operations) ({card})")
    return rec


def cli_render(tmp, src):
    """The CLI's render with contours on the slice scene, and ``--batch``
    on a directory of two scans, as subprocesses on the card."""
    repo = os.path.dirname(os.path.abspath(__file__))

    def run(*argv):
        res = subprocess.run(
            [sys.executable, "-m", "buildingsegment_tpu_torch.cli", *argv],
            cwd=repo, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"CLI {argv} exited {res.returncode}: {res.stderr[-2000:]}")
        return res.stdout

    render = os.path.join(tmp, "cli_render")
    run(f"-a={src}", f"-s={os.path.join(tmp, 'cli_render.ply')}",
        "--render-dir", render, "--extract-contours")
    want = set(RENDER_PNGS) | {"extracted_contours.png",
                               "extracted_contours_flip.png", "csa.obj"}
    got = set(os.listdir(render))
    if not want <= got:
        fail(f"CLI --render-dir --extract-contours wrote {sorted(got)}")
    obj = open(os.path.join(render, "csa.obj")).read()
    if "\nf " not in obj:
        fail("CLI --extract-contours wrote a csa.obj without faces")
    print(f"CLI --render-dir --extract-contours: rc 0, {sorted(got)}, "
          f"csa.obj {len(obj)} bytes")

    in_dir, out_dir = os.path.join(tmp, "batch_in"), os.path.join(tmp,
                                                                  "batch_out")
    os.makedirs(in_dir)
    for name in ("a.ply", "b.ply"):
        shutil.copy(src, os.path.join(in_dir, name))
    line = run("--batch", in_dir, out_dir).strip().splitlines()[-1]
    if not line.startswith("2 scans, ") or sorted(os.listdir(out_dir)) != [
            "a.ply", "b.ply"]:
        fail(f"CLI --batch printed {line!r}, wrote {os.listdir(out_dir)}")
    print(f"CLI --batch: rc 0, {line}")


def splat_terms(torch, pos, mask, th, width, bin_size):
    """The most corner contributions any raster cell sums (the splat's
    addends of one cell)."""
    p = pos[mask & (pos[:, 2] >= th)].long()
    cell = (p[:, 1] // bin_size) * width + p[:, 0] // bin_size
    idx = torch.cat([cell, cell + 1, cell + width, cell + width + 1])
    return int(torch.bincount(idx).max())


def multiscan_phase(torch, np, hooks, cuda_fns, card, results, launches,
                    cols_calls):
    """BASELINE config 5 on the card: four ~1.08M-point scans through
    ``segment_files`` with the render; see the module docstring, step 10.
    Adds the render path's rows to ``results``, the run's counts to
    ``launches`` and #10's inputs from its lookups to ``cols_calls``.
    Returns (the summary, scan 0's labels)."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.io.png import read_png
    from buildingsegment_tpu_torch.pipeline import (
        DEFAULT_CONFIG, HostPointCloud, _bucket_capacity, read_ply,
        segment_cloud, segment_files, write_ply,
    )
    from buildingsegment_tpu_torch.raster import ortho
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    cfg = DEFAULT_CONFIG
    with tempfile.TemporaryDirectory() as tmp:
        srcs, dsts, truths, counts = [], [], [], []
        for seed in range(MULTISCAN_SCANS):
            spts, struth = make_building_cloud(**dict(MULTISCAN_SCENE,
                                                      seed=seed))
            src = os.path.join(tmp, f"scan{seed}.ply")
            # metres in the file, as bench.py writes them
            write_ply(HostPointCloud(positions=spts), src,
                      position_scale=1e-3)
            srcs.append(src)
            dsts.append(os.path.join(tmp, f"out{seed}.ply"))
            truths.append(struth)
            counts.append(len(spts))
        caps = [_bucket_capacity(n, cfg) for n in counts]
        if set(caps) != {MULTISCAN_CAPACITY}:
            fail(f"config-5 scans of {counts} points bucket to {caps}, "
                 f"expected {MULTISCAN_CAPACITY}")
        render = os.path.join(tmp, "render")

        # warm-up, recording every call of every kernel of the path: the
        # default path's eight at this capacity and #8
        seen = {}
        with spying(torch, {k: hooks[k] for k in PATH_KERNELS["render"]},
                    seen):
            segment_files(srcs, dsts, cfg, device="cuda", render_dir=render)
        missing = [k for k in PATH_KERNELS["render"] if k not in seen]
        if missing:
            fail(f"multi-scan warm-up did not reach {missing}")
        if len(seen["plane_sums"]) != MULTISCAN_SCANS:
            fail(f"multi-scan warm-up called plane_sums "
                 f"{len(seen['plane_sums'])} times")
        print(f"warm-up run, render: calls "
              f"{ {k: len(v) for k, v in seen.items()} }")
        cols_calls += lookup_cols_calls(torch, seen["table_lookup_pair"], 1)
        phases = compact_phases(torch, seen["compact_sweep"], card,
                                "config 5, four scans")
        seg_rec = segment_sums_record(torch, "config 5, four scans",
                                      seen["segment_sums"], card)
        for name in PATH_KERNELS["render"]:
            results[("render", name)] = hold_kernel(
                torch, name, "render", seen.pop(name), cuda_fns[name],
                hooks[name][2], card)
        del seen
        shutil.rmtree(render)

        # the measured run
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = segment_files(srcs, dsts, cfg, device="cuda",
                             render_dir=render)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["render"] = dict(kernels.launch_counts)
        for name in PATH_KERNELS["render"]:
            if launches["render"][name] == 0:
                fail(f"multi-scan render path never launched {name}")
        if launches["render"]["plane_sums"] != MULTISCAN_SCANS:
            fail(f"plane_sums launched {launches['render']['plane_sums']} "
                 f"times for {MULTISCAN_SCANS} scans")
        if any(o.device_shifted is not None or o.device_mask is not None
               for o in outs):
            fail("segment_files kept a scan's positions on the card")
        total = sum(counts)
        print(f"multi-scan (config 5): {MULTISCAN_SCANS} scans, {total} "
              f"points in {wall:.4f} s = {total / wall / 1e6:.4f} Mpts/s, "
              f"launches {launches['render']} ({card})")

        per_scan = []
        for seed, (src, dst, out) in enumerate(zip(srcs, dsts, outs)):
            if read_ply(dst).count != counts[seed]:
                fail(f"scan {seed}: labeled PLY does not hold "
                     f"{counts[seed]} points")
            one = segment_cloud(
                read_ply(src, position_scale=cfg.position_scale),
                dataclasses.replace(cfg, pad_to_multiple=caps[seed]),
                device="cuda")
            if not (one.num_planes == out.num_planes
                    and np.array_equal(one.plane_idx, out.plane_idx)
                    and np.array_equal(one.plane_counts, out.plane_counts)):
                fail(f"scan {seed}: segment_files gave {out.num_planes} "
                     f"planes, segment_cloud {one.num_planes}, or the "
                     f"labels differ")
            if seed == 0:
                one0 = one  # its positions stay on the card for the raster
            pngs = sorted(os.listdir(os.path.join(render, f"scan{seed}")))
            if pngs != sorted(RENDER_PNGS):
                fail(f"scan {seed}: render directory holds {pngs}")
            bij = bij_agreement(truths[seed], out.plane_idx)
            per_scan.append({
                "points": counts[seed], "planes": out.num_planes,
                "truth_bij": round(bij, 6), "diagnostics": out.diagnostics,
                "stages_s": {k: round(v, 6) for k, v in out.timings.items()},
            })
            print(f"scan {seed}: {counts[seed]} points, {out.num_planes} "
                  f"planes (== segment_cloud), truth agreement {bij:.6f}, "
                  f"stages {per_scan[-1]['stages_s']}")

        # scan 0: the card's rasters against the CPU's (plain versions),
        # from the positions segment_cloud left on the card (segment_files
        # frees its own once a scan is written)
        out0 = one0
        ext = tuple(int(e) for e in out0.cloud.positions.max(axis=0))
        on_card = ortho.dispatch_ortho(out0.cloud.positions,
                                       out0.device_shifted, out0.device_mask,
                                       cfg).cpu()
        on_cpu = ortho.dispatch_ortho(out0.cloud.positions,
                                      out0.device_shifted.cpu(),
                                      out0.device_mask.cpu(), cfg)
        th = ortho.ground_threshold(out0.device_shifted, out0.device_mask,
                                    ext[2], bin_height=cfg.raster_bin_height)
        terms = splat_terms(torch, out0.device_shifted, out0.device_mask, th,
                            ext[0] // cfg.raster_bin + 2, cfg.raster_bin)
        # the atomics reorder a cell's sum of ``terms`` non-negative
        # addends: each order lies within (terms − 1)·2^-24 of the exact
        # sum, so two orders within twice that, and a ratio of two sums
        # (the mean height) within four times that plus its rounding
        tol = 4 * terms * 2.0 ** -24 + 2.0 ** -23
        err = float(((on_card - on_cpu).abs()
                     / on_cpu.abs().clamp_min(1.0)).max())
        if on_card.shape != on_cpu.shape or err > tol:
            fail(f"scan 0 rasters: card vs CPU relative error {err} > {tol}")
        cpu_dir = os.path.join(tmp, "cpu0")
        ortho.finish_ortho(on_cpu, cpu_dir)
        png_diff = max(
            int(np.abs(read_png(os.path.join(render, "scan0", name))
                       .astype(int)
                       - read_png(os.path.join(cpu_dir, name)).astype(int))
                .max())
            for name in RENDER_PNGS)
        if png_diff > 1:
            fail(f"scan 0 PNGs: card vs CPU differ by {png_diff} in a pixel")
        print(f"scan 0 rasters {tuple(on_card.shape)}: card vs CPU relative "
              f"error {err:.3g} <= {tol:.3g} (cells sum <= {terms} terms), "
              f"PNGs within {png_diff}")

        # the render's own span on scan 0, three runs
        spans = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ortho.render_ortho_views(out0, os.path.join(tmp, "span"), cfg)
            spans.append(time.perf_counter() - t)
        print(f"render_ortho_views on scan 0: {min(spans) * 1e3:.3f}–"
              f"{max(spans) * 1e3:.3f} ms ({card})")
    return {
        "scans": MULTISCAN_SCANS, "points": total, "capacity": caps[0],
        "wall_s": wall, "mpts_per_s": total / wall / 1e6,
        "launches": launches["render"], "per_scan": per_scan,
        "raster_rel_err": err, "raster_tol": tol, "png_max_diff": png_diff,
        "render_span_s": [min(spans), max(spans)],
        "compact_phases": phases, "segment_sums": seg_rec, "card": card,
    }, outs[0].plane_idx


def mxu_full_phase(torch, np, hooks, cuda_fns, card, default_labels0):
    """The ``mxu`` path on config 5's scan 0 at capacity 1,179,648; see the
    module docstring, step 11.  Returns its summary."""
    from buildingsegment_tpu_torch.pipeline import (
        HostPointCloud, _bucket_capacity, segment_file, write_ply,
    )
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    cfg = mxu_config()
    pts, truth = make_building_cloud(**dict(MULTISCAN_SCENE, seed=0))
    cap = _bucket_capacity(len(pts), cfg)
    if cap != MULTISCAN_CAPACITY:
        fail(f"scan 0 ({len(pts)} points) buckets to {cap}")
    cfg = dataclasses.replace(cfg, pad_to_multiple=cap)
    names = ("stats_mxu", "seed_mxu", "stats_sweep", "seed_sweep")
    seen = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "scan0.ply")
        write_ply(HostPointCloud(positions=pts), src, position_scale=1e-3)
        with spying(torch, {k: hooks[k] for k in names}, seen):
            out = segment_file(src, os.path.join(tmp, "out0.ply"), cfg,
                               device="cuda")
    if "stats_sweep" in seen or "seed_sweep" in seen or not (
            "stats_mxu" in seen and "seed_mxu" in seen):
        fail(f"mxu path at full size called {sorted(seen)}")
    if {n for k in seen for n, _a, _k in seen[k]} != {cap}:
        fail(f"mxu path at full size: rows other than {cap}")
    bij = bij_agreement(truth, out.plane_idx)
    cross = bij_agreement(default_labels0, out.plane_idx)
    if cross < 0.99:
        fail(f"mxu path on scan 0: cross agreement {cross:.6f} with the "
             f"default path's labels")
    summary = {"points": len(pts), "capacity": cap,
               "planes": out.num_planes, "truth_bij": round(bij, 6),
               "cross_bij_default": round(cross, 6),
               "calls": {k: len(v) for k, v in seen.items()}, "card": card}
    for name in MXU_REPLACES:
        calls = seen.pop(name)
        hold_calls(torch, name, "mxu full size", calls, cuda_fns[name],
                   hooks[name][2])
        if name == "seed_mxu":
            hold_full_walk(torch, "mxu full size", calls, cuda_fns[name],
                           hooks[name][2])
        summary[name] = block_vs_exact(torch, name, calls, cuda_fns, card,
                                       "mxu path, scan 0")
    print(f"mxu path on scan 0 ({len(pts)} points, capacity {cap}): "
          f"{out.num_planes} planes at truth agreement {bij:.6f}, cross "
          f"agreement {cross:.6f} with the default path")
    return summary


def padded(torch, pts, cap):
    """Scene points padded to ``cap`` rows on the card: (positions, mask)."""
    from buildingsegment_tpu_torch.core.pointset import PointBatch

    batch = PointBatch.upload(pts, cap, device="cuda")
    return batch.positions, batch.mask


def scenes_phase(torch, np, card):
    """The reference's scene tests on the card; see the module docstring,
    step 12.  Returns the record by scene."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.pipeline import (
        HostPointCloud, PipelineConfig, run_device_pipeline, segment_cloud,
    )
    from buildingsegment_tpu_torch.utils import bij_agreement, synthetic

    rec = {}

    def hold(name, n, planes, labels, truth, secs):
        want_n, want_planes, jax_bij = SCENE_EXPECT[name]
        launched = dict(kernels.launch_counts)
        missing = [k for k in PATH_KERNELS["default"] if not launched[k]]
        bij = bij_agreement(truth, labels)
        if n != want_n or planes != want_planes or bij < jax_bij - 0.01:
            fail(f"scene {name}: {n} points, {planes} planes at truth "
                 f"agreement {bij:.6f}; the JAX package: {want_n} points, "
                 f"{want_planes} planes at {jax_bij}")
        if missing:
            fail(f"scene {name}: never launched {missing}")
        rec[name] = {"points": n, "planes": planes, "truth_bij": bij,
                     "jax_truth_bij": jax_bij, "s": secs,
                     "launches": launched}
        print(f"scene {name}: {n} points, {planes} planes (JAX: "
              f"{want_planes}) at truth agreement {bij:.6f} (JAX: "
              f"{jax_bij}), {secs:.3f} s ({card})")

    for name, (builder, kw) in SCENES.items():
        pts, truth = getattr(synthetic, builder)(**kw)
        n = len(pts)
        pos, mask = padded(torch, pts, -(-n // 1024) * 1024)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, seg = run_device_pipeline(pos, mask, **SCENE_RUN)
        labels = seg.plane_idx[:n].cpu().numpy()
        hold(name, n, seg.num_planes, labels, truth,
             time.perf_counter() - t)

    a, ta = synthetic.make_building_cloud(seed=1, spacing_mm=150.0,
                                          noise_mm=8.0)
    b, tb = synthetic.make_building_cloud(seed=2, spacing_mm=150.0,
                                          noise_mm=8.0)
    pts = np.concatenate([a, b + np.array([40_000, 0, 0], np.int32)])
    truth = np.concatenate([ta, tb + ta.max()])
    kernels.reset_launch_counts()
    t = time.perf_counter()
    out = segment_cloud(HostPointCloud(positions=pts),
                        PipelineConfig(**TWO_HOUSES_CONFIG), device="cuda")
    for pid in range(1, out.num_planes + 1):
        x = pts[out.plane_idx == pid][:, 0]
        if x.min() < 20_000 and x.max() > 35_000:
            fail(f"two houses: plane {pid} spans both buildings")
    hold("two_houses", len(pts), out.num_planes, out.plane_idx, truth,
         time.perf_counter() - t)
    return rec


def heal_phase(torch, np, card, src, dst, pts, truth):
    """The multigrid ``heal`` switch; see the module docstring, step 13.
    Returns (the record, #8's row on the multigrid path, #9's row and the
    launch counts of the slice run at heal=False)."""
    from buildingsegment_tpu_torch import kernels, pipeline
    from buildingsegment_tpu_torch.ops import segsum
    from buildingsegment_tpu_torch.seg import coarse
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    spts, struth = make_building_cloud(**SMALL_SCENE)
    hook = {"plane_sums": (coarse, "plane_sums",
                           segsum.plane_sums_reference),
            "table_lookup": (coarse, "table_lookup",
                             segsum.table_lookup_reference)}
    multigrid = pipeline.segment_planes_multigrid
    rec, row, row9, launched_false = {}, None, None, None
    for heal in (False, "merge"):
        pipeline.segment_planes_multigrid = functools.partial(multigrid,
                                                              heal=heal)
        try:
            cfg = pipeline.PipelineConfig(knn_method="window")
            small = [pipeline.segment_cloud(
                pipeline.HostPointCloud(positions=spts), cfg, device=dev)
                for dev in ("cuda", "cpu")]
            cross = bij_agreement(small[1].plane_idx, small[0].plane_idx)
            gap = abs(bij_agreement(struth, small[0].plane_idx)
                      - bij_agreement(struth, small[1].plane_idx))
            if (small[0].num_planes != small[1].num_planes or cross < 0.99
                    or gap >= 0.01):
                fail(f"heal={heal!r}, small scene: card "
                     f"{small[0].num_planes} planes vs CPU "
                     f"{small[1].num_planes}, cross agreement {cross}, "
                     f"truth agreement gap {gap}")
            seen = {}
            with spying(torch, hook, seen):
                pipeline.segment_file(src, dst, pipeline.DEFAULT_CONFIG,
                                      device="cuda")
            kernels.reset_launch_counts()
            out = pipeline.segment_file(src, dst, pipeline.DEFAULT_CONFIG,
                                        device="cuda")
            launched = dict(kernels.launch_counts)
        finally:
            pipeline.segment_planes_multigrid = multigrid
        # the outermost finalize adopts no holes: #9 renumbers there, the
        # pair lookup at the inner level
        want = {"plane_sums": int(heal is False), "plane_adopt": 1,
                "payload_moment_sums": 1 + int(heal is not False),
                "table_lookup": 1, "table_lookup_pair": 1}
        got = {k: launched[k] for k in want}
        if got != want:
            fail(f"heal={heal!r}: launches {got}, expected {want}")
        bij = bij_agreement(truth, out.plane_idx)
        rec[str(heal)] = {
            "small_planes": small[0].num_planes, "small_cross": cross,
            "planes": out.num_planes, "truth_bij": bij,
            "launches": launched,
            "stages_s": {k: round(v, 6) for k, v in out.timings.items()}}
        print(f"heal={heal!r}: small scene card == CPU "
              f"{small[0].num_planes} planes (cross {cross:.4f}); slice "
              f"scene {out.num_planes} planes at truth agreement "
              f"{bij:.6f}, launches {launched} ({card})")
        if heal is False:
            if len(seen.get("plane_sums", ())) != 1:
                fail(f"heal=False: captured {len(seen.get('plane_sums', ()))}"
                     f" plane_sums calls, expected 1")
            row = hold_kernel(torch, "plane_sums", "multigrid heal=False",
                              seen["plane_sums"], kernels.plane_sums_cuda,
                              segsum.plane_sums_reference, card)
            row = timed_row(torch, "plane_sums", row, seen["plane_sums"],
                            kernels.plane_sums_cuda, "multigrid heal=False",
                            card)
            row["launches"] = launched["plane_sums"]
            row9 = hold_kernel(torch, "table_lookup", "multigrid heal=False",
                               seen["table_lookup"], kernels.table_lookup_cuda,
                               segsum.table_lookup_reference, card)
            row9 = timed_row(torch, "table_lookup", row9,
                             seen["table_lookup"], kernels.table_lookup_cuda,
                             "multigrid heal=False", card)
            launched_false = launched
    return rec, row, row9, launched_false


def normals_window_phase(torch, np, hooks, card):
    """``estimate_normals_window`` at bench.py's width; see the module
    docstring, step 14.  Returns (the record, #3's row on this path)."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.core.morton import morton_argsort
    from buildingsegment_tpu_torch.ops.normals import estimate_normals_window
    from buildingsegment_tpu_torch.utils import make_building_cloud

    pts, _ = make_building_cloud(**dict(MULTISCAN_SCENE, seed=0))
    n = len(pts)
    pos, mask = padded(torch, pts, -(-n // 2048) * 2048)
    order = morton_argsort(pos, mask)
    sposf, smask = pos[order].float(), mask[order]

    def run():
        return estimate_normals_window(sposf, smask, radius=100.0, window=64)

    seen = {}
    kernels.reset_launch_counts()
    with spying(torch, {"stats_sweep": hooks["stats_sweep"]}, seen):
        nrm, curv = run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts["stats_sweep"]
    if launches != 1 or len(seen.get("stats_sweep", ())) != 1:
        fail(f"estimate_normals_window launched stats_sweep {launches} "
             f"times")
    _n, _args, kw = seen["stats_sweep"][0]
    if (kw["k"], kw["w"], kw["max_nn"]) != (1, 64, None):
        fail(f"estimate_normals_window called stats_sweep with {kw}")
    length = nrm[smask].norm(dim=1)
    if not (bool(torch.isfinite(nrm).all()) and bool(torch.isfinite(curv)
            .all()) and float((length - 1).abs().max()) < 1e-5):
        fail("estimate_normals_window: non-finite or non-unit normals")
    row = hold_kernel(torch, "stats_sweep", "estimate_normals_window",
                      seen["stats_sweep"], kernels.stats_sweep_cuda,
                      hooks["stats_sweep"][2], card)
    row = timed_row(torch, "stats_sweep", row, seen["stats_sweep"],
                    kernels.stats_sweep_cuda, "estimate_normals_window", card)
    row["launches"] = launches
    ms = cuda_ms(torch, run, 20)
    rec = {"points": n, "rows": sposf.shape[0], "window": 64,
           "radius": 100.0, "ms": ms, "mpts_per_s": n / ms / 1e3,
           "card": card}
    print(f"estimate_normals_window: {n} points ({sposf.shape[0]} rows, "
          f"w = 64, radius 100): {ms:.4f} ms a call = "
          f"{rec['mpts_per_s']:.3f} normals Mpts/s ({card})")
    return rec, row


def cli_flags(tmp, src, small_src, n_small):
    """The CLI's ``--trace``, ``--dump-stages`` and ``--golden`` as
    subprocesses on the card; see the module docstring, step 15."""
    import numpy as np

    from buildingsegment_tpu_torch.io.ply import read_ply
    from buildingsegment_tpu_torch.profiling import TRACE_FILE

    repo = os.path.dirname(os.path.abspath(__file__))

    def run(*argv):
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "buildingsegment_tpu_torch.cli", *argv],
            cwd=repo, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"CLI {argv} exited {res.returncode}: {res.stderr[-2000:]}")
        return res.stdout, time.perf_counter() - t

    trace_dir = os.path.join(tmp, "trace")
    _, secs = run(f"-a={src}", f"-s={os.path.join(tmp, 'trace.ply')}",
                  "--trace", trace_dir)
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel")
    missing = [s for s in TRACE_SPANS if s not in names]
    if missing or not kernels_seen:
        fail(f"CLI --trace: spans {missing} missing, {kernels_seen} card "
             f"kernels")
    print(f"CLI --trace: rc 0 ({secs:.1f} s), {len(events)} events, spans "
          f"{list(TRACE_SPANS)}, {kernels_seen} card kernel events")

    npz = os.path.join(tmp, "stages.npz")
    run(f"-a={src}", f"-s={os.path.join(tmp, 'dump.ply')}", "--dump-stages",
        npz)
    with np.load(npz) as z:
        keys = sorted(z.files)
    if keys != sorted(DUMP_KEYS):
        fail(f"CLI --dump-stages wrote keys {keys}")
    print(f"CLI --dump-stages: rc 0, keys {keys}")

    golden = os.path.join(tmp, "golden.ply")
    out, secs = run(f"-a={small_src}", f"-s={golden}", "--golden")
    if read_ply(golden).count != n_small or "(golden oracle)" not in out:
        fail(f"CLI --golden printed {out!r}")
    print(f"CLI --golden: rc 0 ({secs:.1f} s), {out.strip()}")


def native_phase(np, card, src, spread_native):
    """The native host codec against the numpy codec; see the module
    docstring, step 16.  Returns its record."""
    from buildingsegment_tpu_torch.io.ply import (
        HostPointCloud, read_ply, read_ply_bytes, write_ply, write_ply_bytes,
    )
    from buildingsegment_tpu_torch.native import binding
    from buildingsegment_tpu_torch.seg.colorize import colorize_planes
    from buildingsegment_tpu_torch.utils import make_building_cloud

    def timed(fn, reps=3):
        best = []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            best.append(time.perf_counter() - t)
        return out, min(best) * 1e3

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        scan0, _ = make_building_cloud(**dict(MULTISCAN_SCENE, seed=0))
        scan_src = os.path.join(tmp, "scan0.ply")
        write_ply(HostPointCloud(positions=scan0), scan_src,
                  position_scale=1e-3)
        for name, path in (("slice", src), ("config5_scan0", scan_src)):
            binding.reset_native_calls()
            cloud, t_read = timed(lambda: read_ply(path, 1000.0))
            data, t_read_np = timed(
                lambda: read_ply_bytes(open(path, "rb").read(), 1000.0))
            for attr in ("positions", "colors"):
                a, b = getattr(cloud, attr), getattr(data, attr)
                if (a is None) != (b is None) or (
                        a is not None and not np.array_equal(a, b)):
                    fail(f"native read_ply of {name}: {attr} differs from "
                         f"the numpy codec's")
            labeled = HostPointCloud(
                positions=cloud.positions,
                colors=colorize_planes(np.arange(cloud.count) % 9 - 1, 7))
            dst = os.path.join(tmp, f"{name}.out.ply")
            _, t_write = timed(lambda: write_ply(labeled, dst))
            blob, t_write_np = timed(lambda: write_ply_bytes(labeled))
            with open(dst, "rb") as f:
                if f.read() != blob:
                    fail(f"native write_ply of {name}: bytes differ from "
                         f"the numpy codec's")
            calls = dict(binding.native_calls)
            if calls["read_ply"] != 3 or calls["write_ply"] != 3:
                fail(f"native codec calls on {name}: {calls}")
            rec[name] = {"points": cloud.count, "read_ms": t_read,
                         "read_numpy_ms": t_read_np, "write_ms": t_write,
                         "write_numpy_ms": t_write_np}
            print(f"native codec, {name} ({cloud.count} points): read_ply "
                  f"{t_read:.3f} ms (numpy {t_read_np:.3f}), write_ply "
                  f"{t_write:.3f} ms (numpy {t_write_np:.3f}); bytes and "
                  f"arrays equal the numpy codec's ({card})")
    rec["default_runs_ms"] = spread_native
    print(f"default path with the native codec, three runs (ms): " + ", ".join(
        f"{k} {v[0] * 1e3:.3f}–{v[1] * 1e3:.3f}" for k, v in
        spread_native.items() if k in ("read_ply", "write_ply",
                                       "host_to_device", "total_with_io"))
          + f"; the numpy codec at the previous commit: " + ", ".join(
        f"{k} {a}–{b}" for k, (a, b) in NUMPY_CODEC_MS.items()) + f" ({card})")
    return rec


# the sharded phase: bench.py's scene (config 5's scan 0) through
# dist.sharded_pipeline at world 1 (NCCL) and world 2 (gloo, both ranks
# on the one card)
SHARDED_BACKENDS = {1: "nccl", 2: "gloo"}
SHARDED_NAMES = {1: ("default",), 2: ("default", "mxu")}
# the kernels each sharded run must launch on every rank
SHARDED_KERNELS = {
    "default": ("stats_sweep", "seed_sweep", "label_sweep", "refine_sweep",
                "payload_moment_sums", "table_lookup_pair", "plane_adopt",
                "segment_sums"),
}
SHARDED_KERNELS["mxu"] = ("stats_mxu", "seed_mxu") + SHARDED_KERNELS[
    "default"][2:]
SHARDED_TIMEOUT_S = 300
SHARDED_POINTS = 1082304


def sharded_configs():
    """The sharded phase's configurations by name."""
    from buildingsegment_tpu_torch.pipeline import DEFAULT_CONFIG

    return {"default": DEFAULT_CONFIG, "mxu": mxu_config()}


def device_run(torch, pos, mask, cfg):
    """The one-device ``run_device_pipeline`` of ``cfg`` on the card (the
    window path, no host hints: what ``sharded_pipeline`` computes) →
    host arrays."""
    from buildingsegment_tpu_torch.dist.check import one_device_run

    seg, _ms = one_device_run(pos, mask, cfg, "cuda", cfg.seg_compact)
    return {"plane_idx": seg.plane_idx.cpu().numpy(),
            "num_planes": seg.num_planes,
            "plane_count": seg.plane_count.cpu().numpy()}


def sharded_rank(group, pos_np, mask_np, names, card):
    """One rank of the sharded phase (run by ``dist.spawn``): per
    configuration a warm-up run of ``sharded_pipeline`` recording every
    kernel wrapper call, then the measured run with the launch counts set
    to 0 just before and read just after; then, rank after rank, every
    recorded call held against its plain version on this rank's
    halo-padded inputs (``hold_kernel``).  Returns (per configuration
    the run's record, per (configuration, kernel) the held row)."""
    import torch

    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.dist import sharded_pipeline

    hooks, cuda_fns = kernel_hooks()
    kernels.build()
    pos = torch.from_numpy(pos_np).to(group.device)
    mask = torch.from_numpy(mask_np).to(group.device)
    configs = sharded_configs()
    out, captured = {}, {}
    for name in names:
        fn = sharded_pipeline(group, configs[name])
        seen = {}
        with spying(torch, hooks, seen):
            fn(pos, mask)
        torch.cuda.synchronize()
        captured[name] = seen
        group.barrier()
        group.stats.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        start.record()
        _s, _lo, seg = fn(pos, mask)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        rec = {"num_planes": seg.num_planes,
               "plane_count": seg.plane_count.cpu().numpy(),
               "num_sweeps": seg.num_sweeps, "host_syncs": seg.host_syncs,
               "diagnostics": seg.diagnostics.tolist(),
               "launches": launches, "collectives": dict(vars(group.stats)),
               "event_ms": start.elapsed_time(end), "wall_s": wall}
        if group.rank == 0:
            rec["plane_idx"] = seg.plane_idx.cpu().numpy()
        out[name] = rec
        group.barrier()
    rows = {}
    for r in range(group.world):  # one rank at a time on the card
        if r == group.rank:
            for name, seen in captured.items():
                for kname, calls in seen.items():
                    rows[(name, kname)] = hold_kernel(
                        torch, kname,
                        f"sharded {name}, world {group.world} rank {r}",
                        calls, cuda_fns[kname], hooks[kname][2], card)
                out[name]["segment_sums_pass"] = segment_sums_record(
                    torch, f"sharded {name}, world {group.world} rank {r}",
                    seen["segment_sums"], card)
        group.barrier()
    return out, rows


def sharded_phase(torch, np, card):
    """``dist.sharded_pipeline`` at world 1 and 2 on bench.py's scene; see
    the module docstring, step 17.  Returns the phase's record."""
    from buildingsegment_tpu_torch.dist import spawn
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    pts, truth = make_building_cloud(**MULTISCAN_SCENE)
    n = len(pts)
    if n != SHARDED_POINTS:
        fail(f"sharded phase: scene has {n} points, expected "
             f"{SHARDED_POINTS}")
    pos = np.full((MULTISCAN_CAPACITY, 3), 1 << 24, np.int32)
    pos[:n] = pts
    mask = np.zeros(MULTISCAN_CAPACITY, bool)
    mask[:n] = True
    configs = sharded_configs()
    refs = {
        "default": device_run(torch, pos, mask, configs["default"]),
        "no_compact": device_run(torch, pos, mask, dataclasses.replace(
            configs["default"], seg_compact=False)),
        "mxu_no_compact": device_run(torch, pos, mask, dataclasses.replace(
            configs["mxu"], seg_compact=False)),
    }
    torch.cuda.empty_cache()
    runs, rec = {}, {"points": n, "capacity": MULTISCAN_CAPACITY,
                     "card": card}
    for world in (1, 2):
        try:
            runs[world] = spawn(
                sharded_rank, world, backend=SHARDED_BACKENDS[world],
                device=None, timeout_s=SHARDED_TIMEOUT_S,
                args=(pos, mask, SHARDED_NAMES[world], card))
        except (RuntimeError, TimeoutError) as exc:
            fail(f"sharded phase, world {world}: {exc}")

    def same(got, want, what):
        if not (np.array_equal(got["plane_idx"], want["plane_idx"])
                and got["num_planes"] == want["num_planes"]
                and np.array_equal(got["plane_count"], want["plane_count"])):
            fail(f"sharded phase: {what} differs (planes "
                 f"{got['num_planes']} vs {want['num_planes']}, labels "
                 f"equal on {float((got['plane_idx'] == want['plane_idx']).mean())})")

    w1 = runs[1][0][0]["default"]
    same(w1, refs["default"], "world 1 vs the default one-device run")
    w2 = runs[2][0][0]["default"]
    same(w2, refs["no_compact"], "world 2 vs the seg_compact=False run")
    same(runs[2][0][0]["mxu"], refs["mxu_no_compact"],
         "world 2 mxu vs the one-device mxu run with seg_compact=False")
    cross = bij_agreement(refs["default"]["plane_idx"][:n],
                          w2["plane_idx"][:n])
    ag_d = bij_agreement(truth, refs["default"]["plane_idx"][:n])
    ag_2 = bij_agreement(truth, w2["plane_idx"][:n])
    if (w2["num_planes"] != refs["default"]["num_planes"] or cross < 0.99
            or abs(ag_d - ag_2) >= 0.01):
        fail(f"sharded phase: world 2 vs the default run: planes "
             f"{w2['num_planes']} vs {refs['default']['num_planes']}, cross "
             f"{cross}, truth {ag_2} vs {ag_d}")
    for world, ranks in runs.items():
        for r, (out, rows) in enumerate(ranks):
            for name, got in out.items():
                need = SHARDED_KERNELS[name] + (
                    ("compact_sweep",) if world == 1 else ())
                missing = [k for k in need if got["launches"][k] == 0]
                if missing:
                    fail(f"sharded {name}, world {world} rank {r} never "
                         f"launched {missing}")
                if name == "mxu" and (got["launches"]["stats_sweep"]
                                      or got["launches"]["seed_sweep"]):
                    fail("sharded mxu run launched #3 or #4")
                col = got["collectives"]
                sweeps = max(got["num_sweeps"], 1)
                rec[f"world{world}_rank{r}_{name}"] = {
                    "planes": got["num_planes"],
                    "num_sweeps": got["num_sweeps"],
                    "host_syncs": got["host_syncs"],
                    "diagnostics": got["diagnostics"],
                    "event_ms": got["event_ms"], "wall_s": got["wall_s"],
                    "launches": {k: v for k, v in got["launches"].items()
                                 if v},
                    "collectives": col,
                    "halo_bytes_per_sweep": col["halo_bytes"] / sweeps,
                    "halo_messages_per_sweep": col["halo_messages"] / sweeps,
                    "segment_sums_pass": got["segment_sums_pass"],
                    "kernels": {k: {f: row[f] for f in (
                        "rows", "ms", "plain_ms", "bound_ms", "max_abs_err")}
                        for (nm, k), row in rows.items() if nm == name},
                }
                print(f"sharded {name}, world {world} rank {r}: "
                      f"{got['num_planes']} planes, {got['num_sweeps']} "
                      f"sweeps, {got['wall_s']:.4f} s wall, "
                      f"{got['event_ms']:.3f} ms between CUDA events, "
                      f"{got['host_syncs']} host syncs, "
                      f"{col['reductions']} reductions, {col['gathers']} "
                      f"gathers, halo {col['halo_bytes']} B in "
                      f"{col['halo_messages']} messages "
                      f"({col['halo_bytes'] / sweeps:.1f} B, "
                      f"{col['halo_messages'] / sweeps:.2f} messages a "
                      f"sweep), {col['host_stagings']} host stagings; "
                      f"launches {rec[f'world{world}_rank{r}_{name}']['launches']} "
                      f"({card})")
    rec["cross_bij_default"] = cross
    rec["truth_bij"] = {"default": ag_d, "world2": ag_2}
    print(f"sharded phase: world 1 == default one-device run, world 2 == "
          f"seg_compact=False run and mxu == its one-device run bit for "
          f"bit; world 2 vs default: {w2['num_planes']} planes, cross "
          f"{cross:.6f}, truth {ag_2:.6f} vs {ag_d:.6f} ({card})")
    return rec


def walk_pass_ms(torch, fn, calls, reps):
    """CUDA-event ms a call over ``reps`` passes of every captured call."""
    def one_pass():
        for _n, args, kw in calls:
            fn(*args, **kw)
    return cuda_ms(torch, one_pass, reps) / len(calls)


def graph_phase(torch, hooks, cuda_fns, card, results):
    """The graph solve's edge walk at the exact cell's largest footprint
    (``EXACT_LARGEST_SCENE``, ~1.64M points, "pallas" through
    ``segment_file``): every hop and union of the solve held bit for bit
    against its plain version, the first (largest) call timed beside its
    bytes bound and the plain version, and a pass of all the calls timed
    for both; the measured run launches the hop ``GRAPH_HOPS`` times a
    sweep and the union once a sweep.  Returns the phase's record."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.pipeline import (
        HostPointCloud, PipelineConfig, segment_file, write_ply,
    )
    from buildingsegment_tpu_torch.seg.region_grow import GRAPH_HOPS
    from buildingsegment_tpu_torch.utils import make_building_cloud

    pts, _ = make_building_cloud(**EXACT_LARGEST_SCENE)
    cfg = PipelineConfig(knn_method="pallas")
    seen = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "exact_largest.ply")
        dst = os.path.join(tmp, "labeled.ply")
        write_ply(HostPointCloud(positions=pts), src, position_scale=0.001)
        with spying(torch, {k: hooks[k] for k in GRAPH_WALKS}, seen):
            segment_file(src, dst, cfg, device="cuda")
        kernels.reset_launch_counts()
        out = segment_file(src, dst, cfg, device="cuda")
    launched = {k: kernels.launch_counts[k] for k in GRAPH_WALKS}
    want = {"graph_hop": GRAPH_HOPS * out.num_sweeps,
            "graph_union": out.num_sweeps}
    if launched != want:
        fail(f"exact largest: launches {launched}, expected {want}")
    record = {"points": len(pts), "num_sweeps": out.num_sweeps,
              "launches": launched, "card": card}
    for name in GRAPH_WALKS:
        calls = seen.pop(name)
        row = hold_kernel(torch, name, "exact largest", calls, cuda_fns[name],
                          hooks[name][2], card)
        results[("exact_largest", name)] = row
        row["pass_ms"] = walk_pass_ms(torch, cuda_fns[name], calls, 20)
        row["plain_pass_ms"] = walk_pass_ms(torch, hooks[name][2], calls, 3)
        print(f"{name} (exact largest, {len(calls)} calls): a call of a "
              f"pass {row['pass_ms']:.4f} ms vs plain "
              f"{row['plain_pass_ms']:.4f} ms ({card})")
        record[name] = {k: row[k] for k in ("rows", "ms", "plain_ms",
                                            "bound_ms", "pass_ms",
                                            "plain_pass_ms")}
        del calls
    print(f"exact largest ({len(pts)} points): {out.num_sweeps} sweeps, "
          f"launches {launched}")
    return record


def kernel_hooks():
    """(the module attribute each solver calls for each kernel wrapper and
    the kernel's plain version, each kernel's CUDA wrapper).  The segment
    sums have six callers in two modules: their hook is the CUDA wrapper
    itself, which ``ops.segsum.segment_sums`` calls for card tensors, as
    are the graph walk's (``ops.graph_hop``)."""
    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.ops import (
        adopt, compact_sweep, graph_hop, pallas_knn, segsum, stats_mxu,
        stats_sweep, window_sweep,
    )
    from buildingsegment_tpu_torch.raster import ortho
    from buildingsegment_tpu_torch.seg import coarse, region_grow

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
        "table_lookup_pair": (coarse, "table_lookup_pair",
                              segsum.table_lookup_pair_reference),
        "segment_sums": (kernels, "segment_sums_cuda",
                         segsum.segment_sums_reference),
        "graph_hop": (kernels, "graph_hop_cuda",
                      graph_hop.graph_hop_reference),
        "graph_union": (kernels, "graph_union_cuda",
                        graph_hop.graph_union_reference),
        "plane_adopt": (coarse, "plane_adopt", adopt.plane_adopt_reference),
        "knn_exact": (pallas_knn, "knn_exact",
                      pallas_knn.knn_exact_reference),
        "plane_sums": (ortho, "plane_sums", segsum.plane_sums_reference),
        "stats_mxu": (stats_sweep, "stats_mxu",
                      stats_mxu.stats_mxu_reference),
        "seed_mxu": (region_grow, "seed_sweep_mxu",
                     stats_mxu.seed_sweep_mxu_reference),
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
        "knn_exact": kernels.knn_exact_cuda,
        "plane_sums": kernels.plane_sums_cuda,
        "stats_mxu": kernels.stats_mxu_cuda,
        "seed_mxu": kernels.seed_mxu_cuda,
        "table_lookup_cols": kernels.table_lookup_cols_cuda,
        "table_lookup_pair": kernels.table_lookup_pair_cuda,
        "segment_sums": kernels.segment_sums_cuda,
        "graph_hop": kernels.graph_hop_cuda,
        "graph_union": kernels.graph_union_cuda,
    }
    return hooks, cuda_fns


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    import numpy as np

    from buildingsegment_tpu_torch import kernels
    from buildingsegment_tpu_torch.core.morton import morton_argsort
    from buildingsegment_tpu_torch.core.pointset import PointBatch
    from buildingsegment_tpu_torch.core.quantize import shift_to_origin
    from buildingsegment_tpu_torch.ops import pallas_knn, segsum
    from buildingsegment_tpu_torch.pipeline import (
        DEFAULT_CONFIG, HostPointCloud, PipelineConfig, read_ply,
        resolve_knn_method, segment_cloud, segment_file, write_ply,
    )
    from buildingsegment_tpu_torch.utils import (
        bij_agreement, make_building_cloud,
    )

    hooks, cuda_fns = kernel_hooks()

    # 2. build, the kernels and the native host codec
    t_build = kernels.build()
    print(f"build: {t_build:.2f} s (0 = library already built)")
    from buildingsegment_tpu_torch.native import binding

    t = time.perf_counter()
    if not binding.native_available():
        fail("no C++ compiler for the native host codec")
    print(f"native codec build and load: {time.perf_counter() - t:.2f} s")

    configs = {
        "default": DEFAULT_CONFIG,
        "single_level": PipelineConfig(knn_method="window", seg_group=1,
                                       pad_to_multiple=2048),
        "pallas": PipelineConfig(knn_method="pallas"),
        "mxu": mxu_config(),
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
            with spying(torch, hooks, seen):
                warm = segment_file(src, dst, cfg, device="cuda")
            missing = [k for k in PATH_KERNELS[path] if k not in seen]
            if missing:
                fail(f"{path} path did not reach {missing}")
            print(f"warm-up run, {path}: {warm.num_planes} planes, "
                  f"{warm.num_sweeps} sweeps, calls "
                  f"{ {k: len(v) for k, v in seen.items()} }")

        # 4. every captured call of every kernel against its plain version,
        # bit for bit; the first call at the largest row count is timed.
        # #10 has no caller: its inputs come from the default path's lookups
        cols_calls = lookup_cols_calls(
            torch, captured["default"]["table_lookup_pair"], 0)
        results = {}
        phases = {"slice_default": compact_phases(
            torch, captured["default"]["compact_sweep"], card,
            "default path")}
        for path, seen in captured.items():
            for name, calls in seen.items():
                results[(path, name)] = hold_kernel(
                    torch, name, path, calls, cuda_fns[name], hooks[name][2],
                    card)
            if "seed_mxu" in seen:
                hold_full_walk(torch, path, seen["seed_mxu"],
                               cuda_fns["seed_mxu"], hooks["seed_mxu"][2])
        mxu_pairs = {name: block_vs_exact(torch, name, captured["mxu"][name],
                                          cuda_fns, card, "mxu path")
                     for name in MXU_REPLACES}
        # the segment sums beside the accumulating index_put_ they
        # replace, over each path's calls
        seg_passes = {path: segment_sums_record(
            torch, f"{path} path", captured[path]["segment_sums"], card)
            for path in ("default", "single_level", "pallas", "mxu")}
        for path in ("default", "pallas"):
            timed_row(torch, "segment_sums", results[(path, "segment_sums")],
                      captured[path]["segment_sums"],
                      cuda_fns["segment_sums"], f"{path} path", card)
        # #9's pair lookup beside the launch floor: its card ms at the
        # default path's largest call and an empty kernel's (a one-element
        # add_), both from the profiler in this call
        timed_row(torch, "table_lookup_pair",
                  results[("default", "table_lookup_pair")],
                  captured["default"]["table_lookup_pair"],
                  cuda_fns["table_lookup_pair"], "default path", card)
        # #10 on the slice's lookup inputs (no path calls it)
        results[("default", "table_lookup_cols")] = timed_row(
            torch, "table_lookup_cols", hold_kernel(
                torch, "table_lookup_cols", "default lookups' inputs",
                cols_calls, cuda_fns["table_lookup_cols"],
                segsum.table_lookup_cols_reference, card),
            cols_calls, cuda_fns["table_lookup_cols"],
            "default lookups' inputs", card)
        one = torch.zeros(1, device="cuda")
        floor_ms = card_ms(torch, lambda: one.add_(1.0))
        print(f"launch floor: an empty kernel (one-element add_) card ms "
              f"{floor_ms} a call (profiler) ({card})")
        del captured

        # 5. small input: card (kernels) vs CPU (plain versions)
        spts, _ = make_building_cloud(**SMALL_SCENE)
        for path, cfg in (("default", PipelineConfig(knn_method="window")),
                          ("single_level", configs["single_level"]),
                          ("brute", PipelineConfig(knn_method="brute")),
                          ("pallas", configs["pallas"]),
                          ("mxu", mxu_config(knn_method="window"))):
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
        for path in ("single_level", "pallas", "default", "mxu"):
            kernels.reset_launch_counts()
            out = segment_file(src, dst, configs[path], device="cuda")
            launches[path] = dict(kernels.launch_counts)
            for name in PATH_KERNELS[path]:
                if launches[path][name] == 0:
                    fail(f"{path} path never launched {name}")
            check_output_ply(np, read_ply, dst, out, len(pts))
            bij = bij_agreement(truth, out.plane_idx)
            planes, least = EXPECT[path]
            if out.num_planes != planes or bij < least:
                fail(f"{path}: {out.num_planes} planes at truth agreement "
                     f"{bij:.6f}; expected {planes} at >= {least}")
            if path == "default":
                default_labels = out.plane_idx
                # every finalize adopts holes: the pair lookup renumbers
                if launches[path]["table_lookup"]:
                    fail(f"default path launched table_lookup "
                         f"{launches[path]['table_lookup']} times")
            extra = {}
            if path == "mxu":
                for exact in MXU_REPLACES.values():
                    if launches[path][exact]:
                        fail(f"mxu path launched {exact}")
                cross = bij_agreement(default_labels, out.plane_idx)
                if cross < 0.99:
                    fail(f"mxu path: cross agreement {cross:.6f} with the "
                         f"default path's labels")
                extra["cross_bij_default"] = round(cross, 6)
            summary[path] = {**extra,
                "planes": out.num_planes, "truth_bij": round(bij, 6),
                "num_sweeps": out.num_sweeps, "host_syncs": out.host_syncs,
                "diagnostics": out.diagnostics, "launches": launches[path],
                "stages_s": {k: round(v, 6) for k, v in out.timings.items()},
            }
            print(f"{path} path: {out.num_planes} planes at truth agreement "
                  f"{bij:.6f}, launches {launches[path]}")

        # stage times over three more runs of the default and pallas
        # paths (min, max), each reading and writing through the native
        # codec
        binding.reset_native_calls()
        spread = {path: stage_spread([
            segment_file(src, dst, configs[path], device="cuda").timings
            for _ in range(3)]) for path in ("default", "pallas", "mxu")}
        native_runs = dict(binding.native_calls)
        if native_runs["read_ply"] != 9 or native_runs["write_ply"] != 9:
            fail(f"the measured runs' native codec calls: {native_runs}")

        # 7. "auto" at 60,914 points resolves to the brute path
        apts, atruth = make_building_cloud(**AUTO_SCENE)
        if len(apts) != AUTO_POINTS:
            fail(f"auto scene has {len(apts)} points, expected {AUTO_POINTS}")
        method = resolve_knn_method(DEFAULT_CONFIG,
                                    DEFAULT_CONFIG.padded_count(len(apts)))
        if method != "brute":
            fail(f"auto resolved to {method!r} at {len(apts)} points")
        asrc = os.path.join(tmp, "auto.ply")
        write_ply(HostPointCloud(positions=apts), asrc, position_scale=0.001)
        # the graph solve's sums and edge walk: every call held and timed
        seen = {}
        brute = ("segment_sums",) + GRAPH_WALKS
        with spying(torch, {k: hooks[k] for k in brute}, seen):
            segment_file(asrc, dst, DEFAULT_CONFIG, device="cuda")
        for name in brute:
            if name not in seen:
                fail(f"auto (brute) path did not reach {name}")
            results[("auto", name)] = hold_kernel(
                torch, name, "auto (brute)", seen[name], cuda_fns[name],
                hooks[name][2], card)
        seg_passes["auto"] = segment_sums_record(
            torch, "auto (brute) path", seen.pop("segment_sums"), card)
        kernels.reset_launch_counts()
        out = segment_file(asrc, dst, DEFAULT_CONFIG, device="cuda")
        launches["auto"] = dict(kernels.launch_counts)
        for name in brute:
            if not launches["auto"][name]:
                fail(f"auto (brute) path never launched {name}")
        check_output_ply(np, read_ply, dst, out, len(apts))
        bij = bij_agreement(atruth, out.plane_idx)
        planes, least = EXPECT["auto"]
        if out.num_planes != planes or bij < least:
            fail(f"auto ({method}): {out.num_planes} planes at truth "
                 f"agreement {bij:.6f}; expected {planes} at >= {least}")
        summary["auto"] = {
            "points": len(apts), "method": method, "planes": out.num_planes,
            "truth_bij": round(bij, 6), "num_sweeps": out.num_sweeps,
            "host_syncs": out.host_syncs, "diagnostics": out.diagnostics,
            "launches": launches["auto"],
            "stages_s": {k: round(v, 6) for k, v in out.timings.items()},
        }
        print(f"auto at {len(apts)} points -> {method}: {out.num_planes} "
              f"planes at truth agreement {bij:.6f}")
        spread["auto"] = stage_spread([
            segment_file(asrc, dst, DEFAULT_CONFIG, device="cuda").timings
            for _ in range(3)])

        # 9. the CLI on the card, as a user runs it
        cli_dst = os.path.join(tmp, "cli.ply")
        res = subprocess.run(
            [sys.executable, "-m", "buildingsegment_tpu_torch.cli",
             f"-a={src}", f"-s={cli_dst}", "--knn-method", "pallas",
             "--json-summary"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            fail(f"CLI exited {res.returncode}: {res.stderr[-2000:]}")
        cli = json.loads(res.stdout.strip().splitlines()[-1])
        if cli["planes"] != summary["pallas"]["planes"]:
            fail(f"CLI gave {cli['planes']} planes, segment_file "
                 f"{summary['pallas']['planes']}")
        print(f"CLI --knn-method pallas: rc 0, {cli['planes']} planes")
        cli_render(tmp, src)

        # 13. the multigrid heal switch; 15. the CLI's --trace,
        # --dump-stages, --golden; 16. the native codec
        heal, heal_row, lookup_row, launches["heal_false"] = heal_phase(
            torch, np, card, src, dst, pts, truth)
        results[("heal_false", "table_lookup")] = lookup_row
        small_src = os.path.join(tmp, "small.ply")
        write_ply(HostPointCloud(positions=spts), small_src,
                  position_scale=0.001)
        cli_flags(tmp, src, small_src, len(spts))
        native = native_phase(np, card, src, spread["default"])

    # 8. the config-2 shape: knn_pallas(k=16) at ~1M rows
    cpts, _ = make_building_cloud(**CONFIG2_SCENE)
    if len(cpts) != CONFIG2_POINTS:
        fail(f"config-2 scene has {len(cpts)} points, expected "
             f"{CONFIG2_POINTS}")
    batch = PointBatch.upload(cpts, DEFAULT_CONFIG.padded_count(len(cpts)),
                              device="cuda")
    shifted, _lo, _hi = shift_to_origin(batch.positions, batch.mask)
    order = morton_argsort(shifted, batch.mask)
    spos, smask = shifted[order].contiguous(), batch.mask[order].contiguous()
    calls8 = []
    scan = pallas_knn.knn_exact

    def keep(*args, **kw):
        calls8.append((args, kw))
        return scan(*args, **kw)

    pallas_knn.knn_exact = keep
    try:
        pallas_knn.knn_pallas(spos, smask, 16)
    finally:
        pallas_knn.knn_exact = scan
    knn_ms = cuda_ms(torch, lambda: pallas_knn.knn_pallas(spos, smask, 16), 3)
    args, kw = calls8[0]
    kernel_ms = cuda_ms(torch, lambda: kernels.knn_exact_cuda(*args, **kw), 3)
    got_d, got_i = kernels.knn_exact_cuda(*args, **kw)
    qt = kw["qt"]
    tiles = torch.randperm(spos.shape[0] // qt,
                           generator=torch.Generator().manual_seed(0))[:32]
    rows = (tiles[:, None] * qt + torch.arange(qt)).reshape(-1).to("cuda")
    ref_d, ref_i = pallas_knn.knn_exact_reference(*args, rows=rows, **kw)
    if not (torch.equal(got_d[rows], ref_d) and torch.equal(got_i[rows],
                                                             ref_i)):
        fail("config-2 shape: kernel != plain version on the sampled tiles")
    moved, ops, note = work(torch, "knn_exact", args, kw, (got_d, got_i))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    config2 = {
        "points": len(cpts), "rows": spos.shape[0], "k": 16,
        "knn_pallas_ms": knn_ms, "kernel_ms": kernel_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tiles": note.lstrip("; "),
        "mpts_per_s": len(cpts) / knn_ms / 1e3,
        "sampled_rows_equal": int(rows.shape[0]), "card": card,
    }
    print(f"config-2 shape: knn_pallas(k=16) on {len(cpts)} points "
          f"({spos.shape[0]} rows): {knn_ms:.2f} ms a call "
          f"({config2['mpts_per_s']:.3f} Mpts/s), kernel {kernel_ms:.2f} ms, "
          f"bound {config2['bound_ms']:.6f} ms by {config2['bound_by']} "
          f"({moved} B, {ops} ops{note}); 32 sampled query tiles == plain "
          f"({card})")

    del batch, shifted, order, spos, smask, calls8, args, got_d, got_i

    # 18. the graph walk at the exact cell's largest footprint
    graph_walk = graph_phase(torch, hooks, cuda_fns, card, results)

    # 10. BASELINE config 5: the multi-scan render path at full size
    multiscan, labels0 = multiscan_phase(torch, np, hooks, cuda_fns, card,
                                         results, launches, cols_calls)
    results[("render", "table_lookup_cols")] = timed_row(
        torch, "table_lookup_cols", hold_kernel(
            torch, "table_lookup_cols", "render", cols_calls,
            kernels.table_lookup_cols_cuda,
            segsum.table_lookup_cols_reference, card),
        cols_calls, kernels.table_lookup_cols_cuda, "render lookups' inputs",
        card)
    del cols_calls
    if any(c["table_lookup_cols"] for c in launches.values()):
        fail("a path launched table_lookup_cols, which nothing calls")

    # 11. the mxu path at full size
    mxu_full = mxu_full_phase(torch, np, hooks, cuda_fns, card, labels0)

    # 12. the reference's scene tests; 14. estimate_normals_window
    scenes = scenes_phase(torch, np, card)
    normals_window, normals_row = normals_window_phase(torch, np, hooks,
                                                       card)

    # 17. the sharded pipeline at world 1 (NCCL) and world 2 (gloo)
    sharded = sharded_phase(torch, np, card)

    # the redesigned kernels (stage-then-fold sums, #3's selection, the
    # tiled window gates of #4 and #6, #1's lanes a row) at both sizes,
    # #1 also on the single-level path, and #14 on the pallas path and at
    # the config-2 shape
    fields = ("rows", "ms", "plain_ms", "bound_ms")
    fold = {name: {where: {k: results[(path, name)][k] for k in fields}
                   for where, path in (("slice_default", "default"),
                                       ("config5_scan0", "render"))}
            for name in ("compact_sweep", "payload_moment_sums",
                         "stats_sweep", "plane_adopt", "seed_sweep",
                         "refine_sweep", "label_sweep")}
    fold["label_sweep"]["slice_single_level"] = {
        k: results[("single_level", "label_sweep")][k] for k in fields}
    fold["knn_exact"] = {
        "slice_pallas": {k: results[("pallas", "knn_exact")][k]
                         for k in fields},
        "config2_shape": {"rows": config2["rows"],
                          "ms": config2["kernel_ms"], "plain_ms": None,
                          "bound_ms": config2["bound_ms"]}}
    for name, rec in fold.items():
        print(f"{name}: " + ", ".join(
            f"{where} {r['rows']} rows {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.6f})" for where, r in rec.items()) + f" ({card})")
    print(json.dumps({"points": len(pts), "card": card, "build_s": t_build,
                      "paths": summary, "stages_min_max_s": spread,
                      "config2": config2, "multiscan": multiscan,
                      "mxu_pairs": mxu_pairs, "mxu_full": mxu_full,
                      "fold_kernels": fold, "compact_phases": phases,
                      "scenes": scenes, "heal": heal,
                      "plane_sums_heal_false": heal_row,
                      "normals_window": normals_window,
                      "stats_sweep_normals_window": normals_row,
                      "native_codec": native, "sharded": sharded,
                      "segment_sums_passes": seg_passes,
                      "graph_walk": graph_walk,
                      "launch_floor_card_ms": floor_ms}))
    rows = []
    for name, (src_file, replaces, _r, _pr) in KERNELS.items():
        path = MAIN_PATH[name]
        r = results[(path, name)]
        rows.append({
            "name": name, "route": "cuda", "source": f"{SRC}/{src_file}",
            "replaces": f"{JAX_PKG}/{replaces}",
            "launches": launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
