#!/usr/bin/env python3
"""Time kernels of one checkout of the PyTorch port on the paths' inputs.

Run on a machine with an NVIDIA card:

    python3 tools/ab_kernels.py [--repo DIR] [--label NAME]
        [--kernels compact_sweep,payload_moment_sums | main | off | all]
        [--reps 50] [--host-split] [--knn-probe] [--widths]

Imports ``buildingsegment_tpu_torch`` from DIR (default: this
repository's root; an older commit unpacked with ``git archive`` works
the same), builds its kernels, and runs ``segment_cloud`` on the scenes
the chosen kernels need (``RUNS``): chip_smoke.py's slice scene (222,828
points) under ``DEFAULT_CONFIG``, under ``seg_group=1``, under
``knn_method="pallas"`` and under the ``mxu`` fields, and BASELINE config
5's scan 0 (the house at 25 mm spacing, seed 0, 1,082,304 points) at
capacity 1,179,648 under ``DEFAULT_CONFIG`` (then rendered, as the
multi-scan writer does) and under the ``mxu`` fields, and, for
``knn_exact``, ``knn_pallas(k=16)`` at the BASELINE config-2 shape (the
house at 25.4 mm spacing, 1,046,391 points, capacity 1,046,528,
Morton-sorted, as chip_smoke.py runs it).
Each run captures the inputs of every call of the chosen kernels'
wrappers (any of ``SPIES``; ``main``: the default path's eight; ``off``:
#8, #14, #15 and #16, off the main path; ``all``: both), spied where the
solvers call them, as chip_smoke.py does;
each kernel is then timed on the first call at its largest row count
with CUDA events (one warm-up call, then ``--reps`` calls back to back:
``ms``, which includes the wrapper's host time wherever that exceeds the
device's; ``host_ms``, the host's time to issue a call), then the same
calls again under ``torch.profiler``: the
device time of each CUDA kernel the wrapper launched, per call
(``device_ms``, its sum ``device_ms_total``).  For ``compact_sweep``
(#2), ``by_call`` gives every captured call's row count, live slot
bound and card ms by launch (its six phases and the counters' memset).  ``launch_floor_ms`` is
the profiled device time of a near-empty kernel (a one-element
``add_``), the floor under every launch.  ``--host-split`` also times,
on the host, the parts of the ``label_sweep``, ``seed_sweep`` and
``refine_sweep`` wrappers on their largest call: the checks and
``.contiguous()``, the allocation, ``_stream`` and the ctypes call.
``--knn-probe`` splits the first design of ``knn_exact`` (one thread a
query, the 49-slot rescan after each insert) into scan and inserts on
each run's largest ``knn_exact`` input: it builds ``KNN_PROBE_SRC``, a
copy of that kernel, three ways — as it is; counting the inserts and
the tiles each query tile visits; and with the insert cut out, visiting
the tiles the counting run visited (its result is wrong: timing only)
— and times each with CUDA events.  ``--widths`` times ``plane_sums``
(#8) on seeded inputs of config 5's histogram shape (1,179,648 rows, 12
bins and the masked rows' bin, bound 128) at the payload widths in
``WIDTHS``, where the main path has only one column.  Each ``plane_sums``
record also gives ``fold_chain_rows``, the rows of each 1,024-row
block's most frequent live id: the longest add chain of that block's
fold.  Prints the card line, then
one JSON line.  To compare two commits on one card, run it in turns from
one command: parent, change, change, parent.  Exits non-zero without a
card.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HOUSE = dict(width_mm=12000.0, depth_mm=9000.0, wall_h_mm=6000.0,
             ridge_h_mm=8000.0, noise_mm=8.0)
# the window runs of the default path's kernels
WINDOW_RUNS = ("slice_default", "slice_single_level", "config5_scan0")
# kernel → (module under the package, attribute the solver calls, wrapper
# in kernels.py, the argument whose length is the call's row count, the
# runs that reach it)
SPIES = {
    "compact_sweep": ("seg.region_grow", "compact_sweep",
                      "compact_sweep_cuda", 4, WINDOW_RUNS),
    "payload_moment_sums": ("seg.coarse", "plane_payload_moment_sums",
                            "payload_moment_sums_cuda", 0, WINDOW_RUNS),
    "label_sweep": ("seg.region_grow", "label_sweep", "label_sweep_cuda", 4,
                    WINDOW_RUNS),
    "plane_adopt": ("seg.coarse", "plane_adopt", "plane_adopt_cuda", 1,
                    WINDOW_RUNS),
    "stats_sweep": ("ops.stats_sweep", "stats_sweep", "stats_sweep_cuda", 1,
                    WINDOW_RUNS),
    "seed_sweep": ("seg.region_grow", "seed_sweep", "seed_sweep_cuda", 2,
                   WINDOW_RUNS),
    "refine_sweep": ("seg.coarse", "refine_sweep", "refine_sweep_cuda", 2,
                     WINDOW_RUNS),
    "table_lookup": ("seg.coarse", "table_lookup", "table_lookup_cuda", 0,
                     WINDOW_RUNS),
    "plane_sums": ("raster.ortho", "plane_sums", "plane_sums_cuda", 0,
                   ("config5_scan0",)),
    "knn_exact": ("ops.pallas_knn", "knn_exact", "knn_exact_cuda", 1,
                  ("slice_pallas", "config2_knn")),
    "stats_mxu": ("ops.stats_sweep", "stats_mxu", "stats_mxu_cuda", 1,
                  ("slice_mxu", "config5_scan0_mxu")),
    "seed_mxu": ("seg.region_grow", "seed_sweep_mxu", "seed_mxu_cuda", 2,
                 ("slice_mxu", "config5_scan0_mxu")),
}
#: ``--kernels main``: every kernel of the default path
MAIN = ("stats_sweep", "seed_sweep", "label_sweep", "compact_sweep",
        "refine_sweep", "payload_moment_sums", "table_lookup", "plane_adopt")
#: ``--kernels off``: the kernels off the main path that a path launches
OFF = ("plane_sums", "knn_exact", "stats_mxu", "seed_mxu")
#: the wrappers ``--host-split`` takes apart
SPLIT = ("label_sweep", "seed_sweep", "refine_sweep")
#: ``--widths``: payload widths of #8 beside the histogram's one column
#: (one staged round for 1–2 columns, else 16 columns a round)
WIDTHS = (1, 2, 3, 16, 17, 128)
#: the BASELINE config-2 shape: the house at 25.4 mm spacing, k = 16
CONFIG2_SPACING_MM = 25.4
CONFIG2_K = 16

#: ``--knn-probe``: the first design of csrc/knn_exact.cu's scan (one
#: thread a query, the list unsorted in shared memory, a rescan for the
#: new worst after each insert), with kMode 0 as it is, 1 counting inserts
#: (``stats[0]``) and recording the tiles each query tile visits
#: (``vcount``), 2 with the insert cut out (a passing candidate's d² is
#: summed into the output instead) and the visits fixed to ``vcount``.
KNN_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kMaxQt = 128;
constexpr float kValidGt = -1e7f;

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <int kMode>
__global__ void probe_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ seed_d,
    const int* __restrict__ seed_i, const int* __restrict__ visit,
    const float* __restrict__ visit_d2, const int* __restrict__ counts,
    float* __restrict__ out_d, int* __restrict__ out_i, int kk, int ct,
    int num_c, int w_excl, int* __restrict__ vcount,
    unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  const int qt = blockDim.x;
  float* cx = smem;
  float* cy = cx + ct;
  float* cz = cy + ct;
  float* bd = cz + ct;
  int* bi = reinterpret_cast<int*>(bd + kk * qt);
  __shared__ float red[kMaxQt];
  __shared__ float tau;
  const int t = threadIdx.x;
  const int qtile = blockIdx.x;
  const int q = qtile * qt + t;
  const float qx = px[q], qy = py[q], qz = pz[q];
  const bool qvalid = qx > kValidGt;
  float wd = 0.f;
  int wi = 0, ws = 0;
  for (int s = 0; s < kk; ++s) {
    const float d = seed_d[(size_t)q * kk + s];
    const int i = seed_i[(size_t)q * kk + s];
    bd[s * qt + t] = d;
    bi[s * qt + t] = i;
    if (s == 0 || key_less(wd, wi, d, i)) {
      wd = d;
      wi = i;
      ws = s;
    }
  }
  red[t] = qvalid ? wd : 0.f;
  __syncthreads();
  if (t == 0) {
    float m = 0.f;
    for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
    tau = m;
  }
  __syncthreads();
  unsigned long long inserts = 0;
  float acc = 0.f;
  const int count = kMode == 2 ? vcount[qtile] : counts[qtile];
  int v = 0;
  for (; v < count; ++v) {
    const size_t row = (size_t)qtile * num_c + v;
    if (kMode != 2 && v > 0 && !(visit_d2[row] <= tau)) break;
    const int base = visit[row] * ct;
    for (int j = t; j < ct; j += qt) {
      cx[j] = px[base + j];
      cy[j] = py[base + j];
      cz[j] = pz[base + j];
    }
    __syncthreads();
    if (qvalid) {
      for (int j = 0; j < ct; ++j) {
        const int c = base + j;
        const float x = cx[j];
        if (abs(c - q) <= w_excl || !(x > kValidGt)) continue;
        const float dx = qx - x;
        const float dy = qy - cy[j];
        const float dz = qz - cz[j];
        const float d = dx * dx + dy * dy + dz * dz;
        if (!key_less(d, c, wd, wi)) continue;
        if (kMode == 2) {
          acc += d;
          continue;
        }
        if (kMode == 1) ++inserts;
        bd[ws * qt + t] = d;
        bi[ws * qt + t] = c;
        wd = bd[t];
        wi = bi[t];
        ws = 0;
        for (int s = 1; s < kk; ++s) {
          const float ds = bd[s * qt + t];
          const int is = bi[s * qt + t];
          if (key_less(wd, wi, ds, is)) {
            wd = ds;
            wi = is;
            ws = s;
          }
        }
      }
    }
    red[t] = qvalid ? wd : 0.f;
    __syncthreads();
    if (t == 0) {
      float m = 0.f;
      for (int s = 0; s < qt; ++s) m = fmaxf(m, red[s]);
      tau = m;
    }
    __syncthreads();
  }
  if (kMode == 1) {
    atomicAdd(stats, inserts);
    if (t == 0) vcount[qtile] = v;
  }
  for (int r = 0; r < kk; ++r) {
    int m = r;
    for (int s = r + 1; s < kk; ++s) {
      if (key_less(bd[s * qt + t], bi[s * qt + t], bd[m * qt + t],
                   bi[m * qt + t]))
        m = s;
    }
    const float dm = bd[m * qt + t];
    const int im = bi[m * qt + t];
    bd[m * qt + t] = bd[r * qt + t];
    bi[m * qt + t] = bi[r * qt + t];
    out_d[(size_t)q * kk + r] = kMode == 2 ? dm + acc : dm;
    out_i[(size_t)q * kk + r] = im;
  }
}
}  // namespace

extern "C" int probe_knn(int mode, const float* px, const float* py,
                         const float* pz, const float* seed_d,
                         const int* seed_i, const int* visit,
                         const float* visit_d2, const int* counts,
                         float* out_d, int* out_i, int n, int kk, int qt,
                         int ct, int w_excl, int* vcount,
                         unsigned long long* stats, void* stream) {
  const size_t smem = (size_t)3 * ct * sizeof(float) +
                      (size_t)kk * qt * (sizeof(float) + sizeof(int));
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define PROBE_LAUNCH(M)                                                     \
  err = cudaFuncSetAttribute(probe_kernel<M>,                               \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             static_cast<int>(smem));                       \
  if (err != cudaSuccess) return static_cast<int>(err);                     \
  probe_kernel<M><<<n / qt, qt, smem, st>>>(px, py, pz, seed_d, seed_i,     \
                                            visit, visit_d2, counts, out_d, \
                                            out_i, kk, ct, n / ct, w_excl,  \
                                            vcount, stats);
  if (mode == 0) {
    PROBE_LAUNCH(0)
  } else if (mode == 1) {
    PROBE_LAUNCH(1)
  } else {
    PROBE_LAUNCH(2)
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def clone(torch, x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone(torch, v) for v in x)
    return x


def per_call_ms(torch, fn, reps):
    """Host ms per call of ``fn`` over ``reps`` calls, then synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def host_split(torch, kernels, name, a, kw, reps):
    """Host ms per call of each part of the ``label_sweep``,
    ``seed_sweep`` or ``refine_sweep`` wrapper, step by step as kernels.py
    takes it, and of the whole wrapper."""
    lib = kernels._load()
    if name == "label_sweep":
        pos, nrm, model_n, model_c, label, mask = a
        n = label.shape[0]

        def checks():
            comps = [kernels._f32(t, n, nm)
                     for group, nm in ((pos, "pos"), (nrm, "nrm"),
                                       (model_n, "model_n"),
                                       (model_c, "model_c"))
                     for t in group]
            return comps, label.contiguous(), kernels._mask_bytes(mask, n)

        comps, labc, mask_u8 = checks()

        def alloc():
            return torch.empty_like(labc), torch.empty_like(labc)

        new, best = alloc()

        def call():
            return lib.bst_label_sweep(
                *[t.data_ptr() for t in comps], labc.data_ptr(),
                mask_u8.data_ptr(), new.data_ptr(), best.data_ptr(), n,
                kw["w"], kw["th_thickness"], kw["th_normal_cos"],
                kw["edge_gate2"], kw["inf_label"],
                int(kw.get("signed", False)), kernels._stream(new))
        out = new
        whole = kernels.label_sweep_cuda
    elif name == "seed_sweep":
        pos, nrm, mask, dk = a
        n = mask.shape[0]

        def checks():
            comps = [kernels._f32(t, n, nm)
                     for group, nm in ((pos, "pos"), (nrm, "nrm"))
                     for t in group]
            return comps, kernels._f32(dk, n, "dk"), kernels._mask_bytes(mask, n)

        comps, dkc, mask_u8 = checks()

        def alloc():
            return torch.empty(n, dtype=torch.bool, device=mask.device)

        out = alloc()

        def call():
            return lib.bst_seed_sweep(
                *[t.data_ptr() for t in comps], mask_u8.data_ptr(),
                dkc.data_ptr(), out.data_ptr(), n, kw["w"],
                kw["th_thickness"], kw["th_normal_cos"],
                int(kw.get("signed", False)), kernels._stream(out))
        whole = kernels.seed_sweep_cuda
    else:
        pos, nrm, mask, pid, table, n_live = a
        n = mask.shape[0]

        def checks():
            comps = [kernels._f32(t, n, nm)
                     for group, nm in ((pos, "pos"), (nrm, "nrm"))
                     for t in group]
            p = kernels._cuda_tensor(pid, torch.int32, (n,), "pid")
            tab = kernels._cuda_tensor(table, torch.float32,
                                       (table.shape[0], 4), "table")
            if tab.data_ptr() % 16:
                tab = tab.clone()
            return comps, p, tab, kernels._mask_bytes(mask, n)

        comps, pidc, tab, mask_u8 = checks()
        ntab = min(kernels.ceil128(n_live), table.shape[0])

        def alloc():
            return torch.empty_like(pidc)

        out = alloc()

        def call():
            return lib.bst_refine_sweep(
                *[t.data_ptr() for t in comps], mask_u8.data_ptr(),
                pidc.data_ptr(), tab.data_ptr(), ntab, out.data_ptr(), n,
                kw["w"], kw["th_thickness"], kw["th_normal_cos"],
                kw["edge_gate2"], int(kw.get("signed", False)),
                int(kw.get("clean", False)), int(kw.get("adopt", True)),
                kernels._stream(out))
        whole = kernels.refine_sweep_cuda
    parts = {
        "checks_contiguous": checks, "allocation": alloc,
        "stream": lambda: kernels._stream(out), "ctypes_call": call,
        "whole_wrapper": lambda: whole(*a, **kw),
    }
    return {part: per_call_ms(torch, fn, reps) for part, fn in parts.items()}


def device_ms(torch, profile, activities, fn, a, kw, reps):
    """The profiler's device ms per call of ``fn(*a, **kw)`` by CUDA
    kernel, over ``reps`` calls."""
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn(*a, **kw)
        torch.cuda.synchronize()
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and "CUDA" in str(e.device_type):
            key = e.key.replace("(anonymous namespace)::", "")[:60]
            dev[key] = dev.get(key, 0.0) + us / 1e3 / reps
    return dev


def launch_floor_ms(torch, profile, activities, reps):
    """Profiled device ms of a one-element ``add_``: a near-empty kernel."""
    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    return sum(device_ms(torch, profile, activities, x.add_, (1,), {},
                         reps).values())


def knn_probe(torch, kernels, a, kw, reps):
    """The first design's scan of ``knn_exact`` split into scan and
    inserts on one captured input (``KNN_PROBE_SRC``): ms a call as it
    is, inserts a valid query, tiles visited, and ms with the insert cut
    out over the same tiles."""
    import ctypes

    pos, seed_d, seed_i, visit, visit_d2, counts = a
    n, kk = seed_d.shape
    qt, ct = kw["qt"], kw["ct"]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "knn_probe.cu")
        lib_path = os.path.join(tmp, "knn_probe.so")
        with open(src, "w") as f:
            f.write(KNN_PROBE_SRC)
        subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared",
                        "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_knn.argtypes = [I] + [P] * 10 + [I] * 5 + [P, P, P]
    lib.probe_knn.restype = I
    out_d, out_i = torch.empty_like(seed_d), torch.empty_like(seed_i)
    vcount = torch.zeros(n // qt, dtype=torch.int32, device=seed_d.device)
    stats = torch.zeros(1, dtype=torch.int64, device=seed_d.device)

    def run(mode):
        err = lib.probe_knn(
            mode, *[t.data_ptr() for t in pos], seed_d.data_ptr(),
            seed_i.data_ptr(), visit.data_ptr(), visit_d2.data_ptr(),
            counts.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), n, kk, qt,
            ct, int(kw["w_excl"]), vcount.data_ptr(), stats.data_ptr(),
            kernels._stream(out_d))
        if err:
            raise RuntimeError(f"knn probe: CUDA error {err}")

    run(1)
    torch.cuda.synchronize()
    inserts = int(stats[0])
    valid_q = int((pos[0] > -1e7).sum())
    ref = kernels.knn_exact_cuda(*a, **kw)
    run(0)
    same = torch.equal(out_d, ref[0]) and torch.equal(out_i, ref[1])
    rec = {"k": kk + 1, "rows": n, "inserts": inserts,
           "inserts_per_valid_query": inserts / max(valid_q, 1),
           "tiles_visited": int(vcount.sum()),
           "first_design_equals_kernel": same}
    for mode, key in ((0, "first_design_ms"), (2, "no_insert_ms"),
                      (0, "first_design_ms_again"),
                      (2, "no_insert_ms_again")):
        rec[key] = cuda_event_ms(torch, lambda: run(mode), reps)
    return rec


def cuda_event_ms(torch, fn, reps):
    """CUDA-event ms per call of ``fn`` over ``reps`` calls, one warm-up."""
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


def config2_knn(torch, pts):
    """``knn_pallas(k=16)`` on the config-2 scene as chip_smoke.py runs
    it: uploaded at its capacity, shifted, Morton-sorted."""
    from buildingsegment_tpu_torch.core.morton import morton_argsort
    from buildingsegment_tpu_torch.core.pointset import PointBatch
    from buildingsegment_tpu_torch.core.quantize import shift_to_origin
    from buildingsegment_tpu_torch.ops import pallas_knn
    from buildingsegment_tpu_torch.pipeline import DEFAULT_CONFIG

    batch = PointBatch.upload(pts, DEFAULT_CONFIG.padded_count(len(pts)),
                              device="cuda")
    shifted, _lo, _hi = shift_to_origin(batch.positions, batch.mask)
    order = morton_argsort(shifted, batch.mask)
    spos, smask = shifted[order].contiguous(), batch.mask[order].contiguous()
    pallas_knn.knn_pallas(spos, smask, CONFIG2_K)
    torch.cuda.synchronize()
    return spos.shape[0]


def fold_chain_rows(torch, ids, n_live, table_cap):
    """#8's longest add chain in each 1,024-row block of a call: the rows
    of the block's most frequent live id (median, min and max over the
    blocks)."""
    bound = min(-(-n_live // 128), -(-table_cap // 128)) * 128
    n = ids.shape[0]
    nblk = -(-n // 1024)
    live = (ids >= 0) & (ids < bound)
    key = (torch.arange(n, device=ids.device) // 1024 * bound
           + ids.long())[live]
    top = torch.bincount(key, minlength=nblk * bound).view(nblk, bound)
    top = top.max(1).values.float()
    return {"blocks": nblk, "median": float(top.median()),
            "min": float(top.min()), "max": float(top.max())}


def plane_sums_widths(torch, kernels, profile, activities, reps):
    """#8 at config 5's histogram shape for each payload width in
    ``WIDTHS``: CUDA-event ms, host issue ms and profiler card ms a
    call on seeded ids and payloads."""
    import numpy as np

    rng = np.random.default_rng(61)
    n, bins = 1_179_648, 12
    ids = np.clip(rng.normal(3.0, 2.5, n), 0, bins - 1).astype(np.int32)
    ids[rng.random(n) < 0.08] = bins
    ids = torch.from_numpy(ids).cuda()
    rec = {}
    for cols in WIDTHS:
        pay = torch.from_numpy(
            rng.uniform(0, 3000, (n, cols)).astype(np.float32)).cuda()
        a, kw = (ids, pay, bins), {"table_cap": bins}
        fn = kernels.plane_sums_cuda
        host = per_call_ms(torch, lambda: fn(*a, **kw), reps)
        dev = device_ms(torch, profile, activities, fn, a, kw, reps)
        rec[cols] = {"ms": cuda_event_ms(torch, lambda: fn(*a, **kw), reps),
                     "host_ms": host, "device_ms_total": sum(dev.values()),
                     "device_ms": dev}
    rec["fold_chain_rows"] = fold_chain_rows(torch, ids, bins, bins)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default="compact_sweep,payload_moment_sums")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-split", action="store_true")
    ap.add_argument("--knn-probe", action="store_true")
    ap.add_argument("--widths", action="store_true")
    args = ap.parse_args()
    names = {"main": list(MAIN), "off": list(OFF),
             "all": list(MAIN + OFF)}.get(args.kernels)
    names = names or args.kernels.split(",")
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
    from buildingsegment_tpu_torch.raster import ortho
    from buildingsegment_tpu_torch.utils import make_building_cloud

    pkg = os.path.dirname(os.path.abspath(kernels.__file__))
    build_s = kernels.build()
    slice_pts, _ = make_building_cloud(seed=0, spacing_mm=55.0, **HOUSE)
    scan0, _ = make_building_cloud(seed=0, spacing_mm=25.0, **HOUSE)
    config2_pts = (make_building_cloud(
        seed=0, spacing_mm=CONFIG2_SPACING_MM, **HOUSE)[0]
        if "knn_exact" in names else None)
    scan0_cfg = dataclasses.replace(
        DEFAULT_CONFIG,
        pad_to_multiple=_bucket_capacity(len(scan0), DEFAULT_CONFIG))
    mxu = dict(stats_rank_mode="mxu", seg_seed_mode="mxu")
    # run → (points, configuration, render the result)
    runs = {
        "slice_default": (slice_pts, DEFAULT_CONFIG, False),
        "slice_single_level": (slice_pts, PipelineConfig(
            knn_method="window", seg_group=1, pad_to_multiple=2048), False),
        "config5_scan0": (scan0, scan0_cfg, "plane_sums" in names),
        "slice_pallas": (slice_pts, PipelineConfig(knn_method="pallas"),
                         False),
        "slice_mxu": (slice_pts, PipelineConfig(**mxu), False),
        "config5_scan0_mxu": (scan0, dataclasses.replace(scan0_cfg, **mxu),
                              False),
        "config2_knn": (config2_pts, None, False),
    }
    wanted = {run for name in names for run in SPIES[name][4]}
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": card, "label": args.label, "package": pkg,
           "build_s": build_s, "reps": args.reps,
           "launch_floor_ms": launch_floor_ms(torch, profile, activities,
                                              args.reps),
           "runs": {}}
    for run, (pts, cfg, render) in runs.items():
        if run not in wanted:
            continue
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
            if cfg is None:
                rows_run = config2_knn(torch, pts)
            else:
                res = segment_cloud(HostPointCloud(positions=pts), cfg,
                                    device="cuda")
                if render:
                    with tempfile.TemporaryDirectory() as tmp:
                        ortho.render_ortho_views(res, tmp, cfg)
        finally:
            for name in names:
                mod, fn = orig[name]
                setattr(mod, SPIES[name][1], fn)
        rec = ({"points": len(pts), "rows": rows_run} if cfg is None
               else {"points": len(pts), "planes": res.num_planes})
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
            dev = device_ms(torch, profile, activities, fn, a, kw, args.reps)
            rec[name] = {"calls": len(calls), "rows": max(rows),
                         "ms": start.elapsed_time(end) / args.reps,
                         "host_ms": host * 1e3 / args.reps,
                         "device_ms_total": sum(dev.values()),
                         "device_ms": dev}
            # the card time of the first call at each smaller row count
            rec[name]["device_ms_total_by_rows"] = {
                r: sum(device_ms(torch, profile, activities, fn,
                                 *calls[rows.index(r)], args.reps).values())
                for r in sorted(set(rows)) if r != max(rows)}
            if name == "compact_sweep":
                # #2 by phase: each captured call's live bound and the card
                # ms of each of its launches
                rec[name]["by_call"] = [
                    {"rows": a_[4].shape[0], "bound": int(a_[6]),
                     "device_ms": device_ms(torch, profile, activities, fn,
                                            a_, kw_, args.reps)}
                    for a_, kw_ in calls]
            if name == "plane_sums":
                rec[name]["fold_chain_rows"] = fold_chain_rows(
                    torch, a[0], a[2], kw["table_cap"])
            if args.host_split and name in SPLIT:
                rec[name]["host_split_ms"] = host_split(
                    torch, kernels, name, a, kw, 4 * args.reps)
            if args.knn_probe and name == "knn_exact":
                rec[name]["probe"] = knn_probe(torch, kernels, a, kw,
                                               max(3, args.reps // 10))
        out["runs"][run] = rec
        del seen
    if args.widths and "plane_sums" in names:
        out["plane_sums_widths"] = plane_sums_widths(
            torch, kernels, profile, activities, args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
