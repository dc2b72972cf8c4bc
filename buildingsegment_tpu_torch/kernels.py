"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes`` (pointers and
the stream passed as ``c_void_p``).  The library lands in ``_build/``
next to this file, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.

``-fmad=false`` is deliberate: the window tests are exact min/or chains
over f32 products, and contracting them to FMA would flip gate decisions
against the plain PyTorch versions.

Every C entry point returns ``cudaGetLastError()`` after its launches;
a nonzero code raises here.  Each wrapper adds one to its entry of
:data:`launch_counts` where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = [
    "build",
    "launch_counts",
    "reset_launch_counts",
    "label_sweep_cuda",
    "compact_sweep_cuda",
    "stats_sweep_cuda",
    "seed_sweep_cuda",
    "refine_sweep_cuda",
    "payload_moment_sums_cuda",
    "table_lookup_cuda",
    "plane_sums_cuda",
    "plane_adopt_cuda",
    "knn_exact_cuda",
    "stats_mxu_cuda",
    "seed_mxu_cuda",
    "table_lookup_cols_cuda",
    "table_lookup_pair_cuda",
    "segment_sums_cuda",
    "segment_order_cuda",
    "segment_sort_plan",
    "graph_hop_cuda",
    "graph_union_cuda",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_SOURCES = (
    "label_sweep.cu", "compact_sweep.cu", "stats_sweep.cu", "seed_sweep.cu",
    "refine_sweep.cu", "segsum.cu", "adopt.cu", "knn_exact.cu",
    "stats_mxu.cu", "segment_sum.cu", "segment_sort.cu", "graph_hop.cu",
)
_HEADERS = ("sweep_common.cuh", "block_fold.cuh", "select_rank.cuh",
            "cp_async.cuh", "segment_sort.cuh")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)

#: kernel name → number of launches since the last reset
launch_counts = {
    "label_sweep": 0, "compact_sweep": 0, "stats_sweep": 0,
    "seed_sweep": 0, "refine_sweep": 0, "payload_moment_sums": 0,
    "table_lookup": 0, "plane_adopt": 0, "knn_exact": 0, "plane_sums": 0,
    "stats_mxu": 0, "seed_mxu": 0, "table_lookup_cols": 0,
    "table_lookup_pair": 0, "segment_sums": 0, "segment_order": 0,
    "graph_hop": 0, "graph_union": 0,
}

_lib: Optional[ctypes.CDLL] = None
# the multi-scan pipeline runs on several threads: the first use builds
# and loads the library exactly once
_load_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_Z = ctypes.c_size_t


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand.append(os.path.join(home, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return os.path.join(_BUILD, f"libbst_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> float:
    """Compile the kernels if this source hash has no library yet;
    returns the seconds spent compiling (0.0 when reused)."""
    path = _library_path()
    if os.path.exists(path):
        return 0.0
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _SOURCES:
        obj = os.path.join(_BUILD, f"{src}.{tag}.o")
        cmd = [nvcc, *_NVCC_FLAGS, "-c", os.path.join(_CSRC, src), "-o", obj]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, obj, proc))
    failed = []
    for src, _obj, proc in jobs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(err, file=sys.stderr)
    objs = [obj for _src, obj, _proc in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{path}.{tag}"
        res = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    with _load_lock:
        if _lib is None:
            _bind()
    return _lib


def _bind() -> None:
    global _lib
    build()
    lib = ctypes.CDLL(_library_path())
    lib.bst_error_string.argtypes = [_I]
    lib.bst_error_string.restype = ctypes.c_char_p
    lib.bst_label_sweep.argtypes = [_P] * 16 + [_I, _I, _F, _F, _F, _I, _I, _P]
    lib.bst_label_sweep.restype = _I
    lib.bst_compact_sweep.argtypes = (
        [_P] * 21 + [_I] * 4 + [_F] * 5 + [_I] * 3 + [_P]
    )
    lib.bst_compact_sweep.restype = _I
    lib.bst_stats_sweep.argtypes = [_P] * 5 + [_I] * 4 + [_F, _P]
    lib.bst_seed_sweep.argtypes = [_P] * 9 + [_I, _I, _F, _F, _I, _P]
    lib.bst_refine_sweep.argtypes = (
        [_P] * 9 + [_I, _P, _I, _I, _F, _F, _F, _I, _I, _I, _P]
    )
    lib.bst_paymom.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                               _P]
    lib.bst_lookup.argtypes = [_P, _P, _I, _P, _I, _P]
    lib.bst_adopt.argtypes = [_P] * 10 + [_I, _F, _F, _I, _I, _P]
    lib.bst_knn_exact.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.bst_plane_sums.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _P]
    lib.bst_stats_mxu.argtypes = [_P] * 5 + [_I] * 4 + [_F, _P]
    lib.bst_seed_mxu.argtypes = [_P] * 9 + [_I, _I, _F, _F, _I, _P]
    lib.bst_lookup_cols.argtypes = [_P, _P, _I, _I, _P, _I, _P]
    lib.bst_lookup_pair.argtypes = [_P, _P, _I, _P, _P, _I, _P, _I, _P]
    lib.bst_segment_init.argtypes = []
    lib.bst_segment_scratch.argtypes = [_I] * 5
    lib.bst_segment_scratch.restype = _Z
    lib.bst_segment_sums.argtypes = ([_P, _I, _P, _P] + [_I] * 5
                                     + [_P, _Z, _P, _P])
    lib.bst_segment_order.argtypes = [_P] + [_I] * 5 + [_P, _Z, _P, _P, _P]
    lib.bst_graph_hop.argtypes = [_P] * 6 + [_I] * 3 + [_F, _F, _I, _P]
    lib.bst_graph_union.argtypes = [_P] * 5 + [_I] * 3 + [_F, _F, _I, _P]
    for fn in (lib.bst_stats_sweep, lib.bst_seed_sweep, lib.bst_refine_sweep,
               lib.bst_paymom, lib.bst_lookup, lib.bst_adopt,
               lib.bst_knn_exact, lib.bst_plane_sums, lib.bst_stats_mxu,
               lib.bst_seed_mxu, lib.bst_lookup_cols, lib.bst_lookup_pair,
               lib.bst_segment_init, lib.bst_segment_sums,
               lib.bst_segment_order, lib.bst_graph_hop,
               lib.bst_graph_union):
        fn.restype = _I
    _lib = lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.bst_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _f32(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_cuda:
        raise ValueError(f"{what}: need a CUDA float32[{n}], got "
                         f"{t.dtype}{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _mask_bytes(mask: torch.Tensor, n: int) -> torch.Tensor:
    """The mask as one byte per row (0/1): a bool tensor already is."""
    if (mask.dtype not in (torch.bool, torch.uint8) or mask.shape != (n,)
            or not mask.is_cuda):
        raise ValueError(f"mask: need a CUDA bool[{n}], got {mask.dtype}"
                         f"{tuple(mask.shape)} on {mask.device}")
    return mask.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


#: rows a block of the label sweep's tile owns, the lanes that share a
#: row, and the widest window the tile takes (kLabelRows, kLabelLanes,
#: kLabelTileMaxW in csrc/label_sweep.cu); a wider window takes its
#: one-thread-a-row kernel
LABEL_TILE_ROWS = 64
LABEL_TILE_LANES = 4
LABEL_TILE_MAX_W = 2048


def label_sweep_cuda(
    pos, nrm, model_n, model_c, label, mask, *, w, th_thickness,
    th_normal_cos, edge_gate2, inf_label, signed=False,
):
    """CUDA ``label_sweep`` (csrc/label_sweep.cu): a staged tile with four
    lanes a row, or one thread a row above ``LABEL_TILE_MAX_W``; see
    :func:`buildingsegment_tpu_torch.ops.window_sweep.label_sweep`."""
    n = label.shape[0]
    if label.dtype != torch.int32 or not label.is_cuda:
        raise ValueError("label: need a CUDA int32 tensor")
    comps = [
        _f32(t, n, name)
        for group, name in ((pos, "pos"), (nrm, "nrm"),
                            (model_n, "model_n"), (model_c, "model_c"))
        for t in group
    ]
    label = label.contiguous()
    mask_u8 = _mask_bytes(mask, n)
    new = torch.empty_like(label)
    best = torch.empty_like(label)
    lib = _load()
    err = lib.bst_label_sweep(
        *[t.data_ptr() for t in comps], label.data_ptr(),
        mask_u8.data_ptr(), new.data_ptr(), best.data_ptr(),
        n, w, th_thickness, th_normal_cos, edge_gate2, inf_label,
        int(signed), _stream(label),
    )
    _check(lib, err, "label_sweep")
    launch_counts["label_sweep"] += 1
    return new, best


#: rows per stats block of the compact sweep (kStatsRows in
#: csrc/compact_sweep.cu; block b covers rows [b·1024 − w, (b+1)·1024 − w))
COMPACT_STATS_ROWS = 1024
#: ids the stage-then-fold sums take (csrc/block_fold.cuh): below 2^21 − 1
FOLD_ID_LIMIT = (1 << 21) - 1


def compact_sweep_cuda(
    pos, nrm, cnrm, mask, clabel, anchor, bound, *, lc, w, th_thickness,
    th_normal_cos, edge_gate2, root_gate, th_anchor_cos, anchor_gate,
    signed=False, jump_rounds=2, stats_out=None,
):
    """CUDA ``compact_sweep`` (csrc/compact_sweep.cu); see
    :func:`buildingsegment_tpu_torch.ops.compact_sweep.compact_sweep`.
    ``stats_out``, a CUDA f32[lc, 16], receives the per-slot sums the
    sweep computed (``ops.compact_sweep.compact_slot_stats``), for
    checks against the plain version."""
    n = clabel.shape[0]
    if clabel.dtype != torch.int32 or not clabel.is_cuda:
        raise ValueError("clabel: need a CUDA int32 tensor")
    if not 1 <= bound <= lc < FOLD_ID_LIMIT:
        raise ValueError(f"slot bound {bound} outside [1, {lc}], or "
                         f"{lc} slots not below {FOLD_ID_LIMIT}")
    if stats_out is not None:
        _cuda_tensor(stats_out, torch.float32, (lc, 16), "stats_out")
        if not stats_out.is_contiguous():
            raise ValueError("stats_out: need a contiguous tensor")
    comps = [
        _f32(t, n, name)
        for group, name in ((pos, "pos"), (nrm, "nrm"), (cnrm, "cnrm"))
        for t in group
    ]
    if (anchor.shape != (lc, 3) or anchor.dtype != torch.float32
            or not anchor.is_cuda):
        raise ValueError(f"anchor: need a CUDA float32[{lc}, 3]")
    dev = clabel.device
    clabel = clabel.contiguous()
    anchor = anchor.contiguous()
    mask_u8 = _mask_bytes(mask, n)
    nblk = -(-(n + w) // COMPACT_STATS_ROWS)
    partial = torch.empty((nblk, lc, 16), dtype=torch.float32, device=dev)
    touched = torch.empty((nblk, lc), dtype=torch.uint8, device=dev)
    mtab = torch.empty((lc, 6), dtype=torch.float32, device=dev)
    ptab = torch.empty((lc, 10), dtype=torch.float32, device=dev)
    parent = torch.empty(lc, dtype=torch.int32, device=dev)
    hop = torch.empty(n, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    lib = _load()
    err = lib.bst_compact_sweep(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(),
        clabel.data_ptr(),
        anchor.data_ptr(), partial.data_ptr(), touched.data_ptr(),
        mtab.data_ptr(), ptab.data_ptr(),
        None if stats_out is None else stats_out.data_ptr(),
        parent.data_ptr(), hop.data_ptr(), out.data_ptr(),
        counters.data_ptr(),
        n, w, lc, int(bound), th_thickness, th_normal_cos, edge_gate2,
        th_anchor_cos, root_gate, int(anchor_gate),
        int(signed), jump_rounds, _stream(clabel),
    )
    _check(lib, err, "compact_sweep")
    launch_counts["compact_sweep"] += 1
    return out, counters


def _cuda_tensor(t: torch.Tensor, dtype, shape, what: str) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda:
        raise ValueError(f"{what}: need a CUDA {dtype}{tuple(shape)}, got "
                         f"{t.dtype}{tuple(t.shape)} on {t.device}")
    return t.contiguous()


def ceil128(x: int) -> int:
    """``x`` rounded up to a multiple of 128 (the TPU kernels' id chunk:
    the live bound of the table kernels)."""
    return -(-int(x) // 128) * 128


def _stats_ranks(k, w, radius, max_nn):
    """(rank of the k-th NN among the 2w candidates, rank of the hybrid
    cap or 0 when the cap is wider than the window, f32 radius²)."""
    cap_active = max_nn is not None and (max_nn - 1) < 2 * w
    r2 = float(np.float32(radius) * np.float32(radius))
    return k - 1, (max_nn - 1) if cap_active else 0, r2


#: widest window half-width the stats sweep takes (csrc/stats_sweep.cu
#: stages a block's 256 rows and their 2w neighbours, 16 B each, in
#: shared memory)
STATS_MAX_W = 4096
#: rows summed in order by one block of the payload-moment sums
#: (kPaymomRows in csrc/segsum.cu, block_fold::kRows) and of the adoption
#: sums (kAdoptRows in csrc/adopt.cu); the plain versions use the same
#: blocks
PAYMOM_ROWS = 1024
ADOPT_ROWS = 256
ADOPT_LANES = 128
#: rows summed in order by one block of the segment sums (kSegsumRows in
#: csrc/segsum.cu, block_fold::kRows); the plain version uses the same
#: blocks
SEGSUM_ROWS = 1024
#: widest payload the segment-sum kernel takes (the TPU kernel's lane row)
SEGSUM_MAX_COLS = 128


def stats_sweep_cuda(pos, mask, *, k, w, radius, max_nn):
    """CUDA stats sweep (csrc/stats_sweep.cu); see
    :func:`buildingsegment_tpu_torch.ops.stats_sweep.stats_sweep`."""
    if not 1 <= w <= STATS_MAX_W:
        raise ValueError(f"stats_sweep: w={w} outside [1, {STATS_MAX_W}]")
    n = mask.shape[0]
    comps = [_f32(t, n, "pos") for t in pos]
    mask_u8 = _mask_bytes(mask, n)
    r_k, r_cap, r2 = _stats_ranks(k, w, radius, max_nn)
    out = torch.empty((11, n), dtype=torch.float32, device=mask.device)
    lib = _load()
    err = lib.bst_stats_sweep(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(), out.data_ptr(),
        n, w, r_k, r_cap, r2, _stream(out),
    )
    _check(lib, err, "stats_sweep")
    launch_counts["stats_sweep"] += 1
    return out[0], out[1], out[2:5].T, out[5:11].T


#: rows a block of the seed sweep's tile owns, and the widest window the
#: tile takes (kSeedRows, kSeedTileMaxW in csrc/seed_sweep.cu); a wider
#: window takes its per-row kernel
SEED_TILE_ROWS = 512
SEED_TILE_MAX_W = 3072
#: rows a block of the refinement sweep's tile owns, and the widest window
#: the tile takes (kRefineRows, kRefineTileMaxW in csrc/refine_sweep.cu);
#: a wider window takes its per-row kernel
REFINE_TILE_ROWS = 256
REFINE_TILE_MAX_W = 3072
#: lanes that search one hole row's candidates (kRefineGroup)
REFINE_TILE_GROUP = 8


def seed_sweep_cuda(pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos,
                    signed=False):
    """CUDA seed sweep (csrc/seed_sweep.cu): unordered pairs from a
    shared-memory tile, or one thread a row above ``SEED_TILE_MAX_W``; see
    :func:`buildingsegment_tpu_torch.ops.window_sweep.seed_sweep`."""
    n = mask.shape[0]
    comps = [_f32(t, n, name) for group, name in ((pos, "pos"), (nrm, "nrm"))
             for t in group]
    dk = _f32(dk, n, "dk")
    mask_u8 = _mask_bytes(mask, n)
    seed = torch.empty(n, dtype=torch.bool, device=mask.device)
    lib = _load()
    err = lib.bst_seed_sweep(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(), dk.data_ptr(),
        seed.data_ptr(), n, w, th_thickness, th_normal_cos, int(signed),
        _stream(seed),
    )
    _check(lib, err, "seed_sweep")
    launch_counts["seed_sweep"] += 1
    return seed


#: the block-form stats sweep ranks and gates a query's 2w + 1 window
#: slots only (csrc/stats_mxu.cu), which gives the block form's outputs
#: while r² stays below the 1e29 mask cut; its block stages 128 + 2w
#: candidates (20 B each) in shared memory up to w = 4,096
STATS_MXU_MAX_W = 4096
STATS_MXU_MAX_R2 = float(np.float32(1e29))


def stats_mxu_cuda(pos, mask, *, k, w, radius, max_nn):
    """CUDA block-form stats sweep (csrc/stats_mxu.cu): 1 ≤ w ≤
    ``STATS_MXU_MAX_W``, radius² below ``STATS_MXU_MAX_R2``, k ≥ 1,
    max_nn None or ≥ 1; see
    :func:`buildingsegment_tpu_torch.ops.stats_mxu.stats_mxu`."""
    # imported here: ops.stats_mxu imports this module
    from buildingsegment_tpu_torch.ops.stats_mxu import mxu_r2, mxu_ranks

    r2 = mxu_r2(radius)
    if not (1 <= w <= STATS_MXU_MAX_W and r2 < STATS_MXU_MAX_R2 and k >= 1
            and (max_nn is None or max_nn >= 1)):
        raise ValueError(
            f"stats_mxu: w={w} (1..{STATS_MXU_MAX_W}), radius²={r2} (below "
            f"{STATS_MXU_MAX_R2}), k={k} (≥ 1) or max_nn={max_nn} (None or "
            f"≥ 1) not supported")
    n = mask.shape[0]
    comps = [_f32(t, n, "pos") for t in pos]
    mask_u8 = _mask_bytes(mask, n)
    r_k, r_cap = mxu_ranks(k, w, max_nn)
    out = torch.empty((11, n), dtype=torch.float32, device=mask.device)
    lib = _load()
    err = lib.bst_stats_mxu(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(), out.data_ptr(),
        n, w, r_k, r_cap, r2, _stream(out),
    )
    _check(lib, err, "stats_mxu")
    launch_counts["stats_mxu"] += 1
    return out[0], out[1], out[2:5].T, out[5:11].T


def seed_mxu_cuda(pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos,
                  signed=False):
    """CUDA block-form seed sweep (csrc/stats_mxu.cu); see
    :func:`buildingsegment_tpu_torch.ops.stats_mxu.seed_sweep_mxu`."""
    n = mask.shape[0]
    comps = [_f32(t, n, name) for group, name in ((pos, "pos"), (nrm, "nrm"))
             for t in group]
    dk = _f32(dk, n, "dk")
    mask_u8 = _mask_bytes(mask, n)
    seed = torch.empty(n, dtype=torch.bool, device=mask.device)
    lib = _load()
    err = lib.bst_seed_mxu(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(), dk.data_ptr(),
        seed.data_ptr(), n, w, th_thickness, th_normal_cos, int(signed),
        _stream(seed),
    )
    _check(lib, err, "seed_mxu")
    launch_counts["seed_mxu"] += 1
    return seed


def refine_sweep_cuda(pos, nrm, mask, pid, table, n_live, *, w, th_thickness,
                      th_normal_cos, edge_gate2, signed=False, clean=False,
                      adopt=True):
    """CUDA refinement sweep (csrc/refine_sweep.cu): a staged tile with
    eight lanes for each hole row, or one thread a row above
    ``REFINE_TILE_MAX_W``; see
    :func:`buildingsegment_tpu_torch.ops.window_sweep.refine_sweep`."""
    n = mask.shape[0]
    comps = [_f32(t, n, name) for group, name in ((pos, "pos"), (nrm, "nrm"))
             for t in group]
    pid = _cuda_tensor(pid, torch.int32, (n,), "pid")
    p = table.shape[0]
    table = _cuda_tensor(table, torch.float32, (p, 4), "table")
    if table.data_ptr() % 16:  # read as float4 rows
        table = table.clone()
    ntab = min(ceil128(n_live), p)
    mask_u8 = _mask_bytes(mask, n)
    out = torch.empty_like(pid)
    lib = _load()
    err = lib.bst_refine_sweep(
        *[t.data_ptr() for t in comps], mask_u8.data_ptr(), pid.data_ptr(),
        table.data_ptr(), ntab, out.data_ptr(), n, w, th_thickness,
        th_normal_cos, edge_gate2, int(signed), int(clean), int(adopt),
        _stream(out),
    )
    _check(lib, err, "refine_sweep")
    launch_counts["refine_sweep"] += 1
    return out


def payload_moment_sums_cuda(ids, payload, q, n_live, *, table_cap,
                             init=None):
    """CUDA payload sums + second moments (csrc/segsum.cu); see
    :func:`buildingsegment_tpu_torch.ops.segsum.plane_payload_moment_sums`."""
    n = ids.shape[0]
    ids = _cuda_tensor(ids, torch.int32, (n,), "ids")
    payload = _cuda_tensor(payload, torch.float32, (n, 8), "payload")
    q = _cuda_tensor(q, torch.float32, (q.shape[0], 3), "q")
    cap128 = ceil128(table_cap)
    bound = min(ceil128(n_live), cap128)
    dev = ids.device
    if init is None:
        sums = torch.zeros((cap128, 8), dtype=torch.float32, device=dev)
        moments = torch.zeros((cap128, 6), dtype=torch.float32, device=dev)
    else:
        # the reduce adds the block tables onto the rows already there
        sums = _cuda_tensor(init[0], torch.float32, (cap128, 8),
                            "init sums").clone()
        moments = _cuda_tensor(init[1], torch.float32, (cap128, 6),
                               "init moments").clone()
    if bound == 0:  # no live id: nothing to sum, nothing launched
        return sums, moments
    if bound >= FOLD_ID_LIMIT:
        raise ValueError(f"payload_moment_sums: live bound {bound} not below "
                         f"{FOLD_ID_LIMIT}")
    nblk = -(-n // PAYMOM_ROWS)
    # written only where a block touches an id (flagged in ``touched``)
    partial = torch.empty((nblk, bound, 16), dtype=torch.float32, device=dev)
    touched = torch.empty((nblk, bound), dtype=torch.uint8, device=dev)
    lib = _load()
    err = lib.bst_paymom(
        ids.data_ptr(), payload.data_ptr(), q.data_ptr(), q.shape[0],
        partial.data_ptr(), touched.data_ptr(), sums.data_ptr(),
        moments.data_ptr(), n, bound, int(init is not None), _stream(ids),
    )
    _check(lib, err, "payload_moment_sums")
    launch_counts["payload_moment_sums"] += 1
    return sums, moments


def table_lookup_cuda(ids, lut, n_live):
    """CUDA table lookup (csrc/segsum.cu); see
    :func:`buildingsegment_tpu_torch.ops.segsum.table_lookup`."""
    n = ids.shape[0]
    ids = _cuda_tensor(ids, torch.int32, (n,), "ids")
    lut = _cuda_tensor(lut, torch.int32, (lut.shape[0],), "lut")
    bound = min(ceil128(n_live), lut.shape[0])
    out = torch.empty_like(ids)
    lib = _load()
    err = lib.bst_lookup(ids.data_ptr(), lut.data_ptr(), bound,
                         out.data_ptr(), n, _stream(out))
    _check(lib, err, "table_lookup")
    launch_counts["table_lookup"] += 1
    return out


def table_lookup_pair_cuda(ids_a, lut_a, ids_b, lut_b, n_live):
    """CUDA pair lookup (csrc/segsum.cu, #9 redesigned): both tables
    staged in shared memory, one launch; see
    :func:`buildingsegment_tpu_torch.ops.segsum.table_lookup_pair`."""
    n = ids_a.shape[0]
    ids_a = _cuda_tensor(ids_a, torch.int32, (n,), "ids_a")
    ids_b = _cuda_tensor(ids_b, torch.int32, (n,), "ids_b")
    lut_a = _cuda_tensor(lut_a, torch.int32, (lut_a.shape[0],), "lut_a")
    lut_b = _cuda_tensor(lut_b, torch.int32, (lut_b.shape[0],), "lut_b")
    out = torch.empty_like(ids_a)
    if n == 0:
        return out
    lib = _load()
    err = lib.bst_lookup_pair(
        ids_a.data_ptr(), lut_a.data_ptr(), min(ceil128(n_live),
                                                lut_a.shape[0]),
        ids_b.data_ptr(), lut_b.data_ptr(), min(ceil128(n_live),
                                                lut_b.shape[0]),
        out.data_ptr(), n, _stream(out))
    _check(lib, err, "table_lookup_pair")
    launch_counts["table_lookup_pair"] += 1
    return out


#: widest rows the fixed-order segment sums take (kMaxCols in
#: csrc/segment_sum.cu: a lane a column, at most 16 lanes an id)
SEGMENT_SUMS_MAX_COLS = 16
#: sizes and row counts the segment sums take: int32 positions and ids
SEGMENT_SUMS_LIMIT = (1 << 31) - 1
#: widest digit a pass of the segment sums' sort ranks (kMaxDigitBits in
#: csrc/segment_sort.cuh: 2,048 counters a warp)
SEGMENT_SORT_MAX_DIGIT = 11
# devices whose segment kernels have their shared-memory limits set
_segment_ready = set()


def segment_sort_plan(size: int):
    """(key bits, passes, digit bits) of the segment sums' sort for ids in
    [0, ``size``): the bits the largest id needs, ``bit_length(size −
    1)``, in the fewest passes of at most :data:`SEGMENT_SORT_MAX_DIGIT`
    bits, split evenly — one pass up to 2,048 ids, two up to 2^22, three
    up to 2^31 − 1.  ``size`` = 1 takes one pass of no bits."""
    bits = (int(size) - 1).bit_length()
    passes = max(1, -(-bits // SEGMENT_SORT_MAX_DIGIT))
    return bits, passes, -(-bits // passes)


def _segment_lib(idx, size, what):
    """The library, ready on ``idx``'s device, after the checks both
    segment wrappers make; returns (lib, idx contiguous, plan)."""
    m = idx.shape[0]
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64) \
            or not idx.is_cuda:
        raise ValueError(f"{what}: idx must be a CUDA int32/int64 [M], got "
                         f"{idx.dtype}{tuple(idx.shape)} on {idx.device}")
    if not (1 <= size < SEGMENT_SUMS_LIMIT and m < SEGMENT_SUMS_LIMIT):
        raise ValueError(f"{what}: size {size} or {m} rows outside "
                         f"1 <= size < 2^31 - 1, rows < 2^31 - 1")
    lib = _load()
    dev = idx.device
    with _load_lock:
        if dev.index not in _segment_ready:
            with torch.cuda.device(dev):
                _check(lib, lib.bst_segment_init(), what)
            _segment_ready.add(dev.index)
    return lib, idx.contiguous(), segment_sort_plan(size)


def segment_sums_cuda(idx, rows, size, init=None):
    """CUDA fixed-order per-id sums (csrc/segment_sum.cu): the live rows
    ordered stably by id by the sort of csrc/segment_sort.cu, which
    writes their columns in that order, then the fold and the long-run
    fold, all launched in one call on one scratch allocation; see
    :func:`buildingsegment_tpu_torch.ops.segsum.segment_sums`."""
    m = idx.shape[0]
    cols = rows.shape[1] if rows.dim() == 2 else 0
    if not 1 <= cols <= SEGMENT_SUMS_MAX_COLS:
        raise ValueError(f"segment_sums: rows must be [M, 1..."
                         f"{SEGMENT_SUMS_MAX_COLS}], got {tuple(rows.shape)}")
    lib, idx, (_bits, passes, digit) = _segment_lib(idx, size,
                                                    "segment_sums")
    rows = _cuda_tensor(rows, torch.float32, (m, cols), "rows")
    if init is not None:
        init = _cuda_tensor(init, torch.float32, (size, cols), "init")
    dev = idx.device
    if rows.device != dev:
        raise ValueError(f"segment_sums: idx on {dev}, rows on {rows.device}")
    nbytes = lib.bst_segment_scratch(m, cols, size, passes, digit)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty((size, cols), dtype=torch.float32, device=dev)
    err = lib.bst_segment_sums(
        idx.data_ptr(), idx.dtype == torch.int64, rows.data_ptr(),
        None if init is None else init.data_ptr(), m, cols, size, passes,
        digit, scratch.data_ptr(), nbytes, out.data_ptr(), _stream(out))
    _check(lib, err, "segment_sums")
    launch_counts["segment_sums"] += 1
    return out


def segment_order_cuda(idx, size):
    """The segment sums' order alone (csrc/segment_sort.cu): (perm
    int32[M], start int32[size], end int32[size]).  ``perm[:n]`` lists the
    n rows whose id lies in [0, ``size``) stably by id (its tail is not
    written); id s's rows sit at ``perm[start[s]:end[s]]``, and an id
    without rows has start = end = −1.  No caller on the pipeline: the
    tests and chip_smoke.py hold it against
    :func:`buildingsegment_tpu_torch.ops.segsum.segment_order_reference`
    and time it beside ``torch.sort``."""
    lib, idx, (_bits, passes, digit) = _segment_lib(idx, size,
                                                    "segment_order")
    m = idx.shape[0]
    dev = idx.device
    nbytes = lib.bst_segment_scratch(m, 0, size, passes, digit)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    perm = torch.empty(m, dtype=torch.int32, device=dev)
    runs = torch.empty((2, size), dtype=torch.int32, device=dev)
    err = lib.bst_segment_order(
        idx.data_ptr(), idx.dtype == torch.int64, m, size, passes, digit,
        scratch.data_ptr(), nbytes, perm.data_ptr(), runs.data_ptr(),
        _stream(perm))
    _check(lib, err, "segment_order")
    launch_counts["segment_order"] += 1
    return perm, runs[0], runs[1]


#: widest table the column lookup takes (the TPU kernel's 8 sublanes)
LOOKUP_COLS_MAX = 8


def table_lookup_cols_cuda(ids, lut, n_live):
    """CUDA multi-column table lookup (csrc/segsum.cu); see
    :func:`buildingsegment_tpu_torch.ops.segsum.table_lookup_cols`."""
    n = ids.shape[0]
    if lut.dim() != 2 or not 1 <= lut.shape[1] <= LOOKUP_COLS_MAX:
        raise ValueError(f"table_lookup_cols: lut must be [cap, 1..8], got "
                         f"{tuple(lut.shape)}")
    cap, cols = lut.shape
    ids = _cuda_tensor(ids, torch.int32, (n,), "ids")
    lut = _cuda_tensor(lut, torch.float32, (cap, cols), "lut")
    out = torch.empty((cols, n), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    lib = _load()
    err = lib.bst_lookup_cols(ids.data_ptr(), lut.data_ptr(), cols,
                              min(ceil128(n_live), cap), out.data_ptr(), n,
                              _stream(out))
    _check(lib, err, "table_lookup_cols")
    launch_counts["table_lookup_cols"] += 1
    return out


def plane_sums_cuda(ids, payload, n_live, *, table_cap):
    """CUDA per-id sums (csrc/segsum.cu): stage-then-fold block partials
    for a live bound below ``FOLD_ID_LIMIT``; see
    :func:`buildingsegment_tpu_torch.ops.segsum.plane_sums`."""
    n = ids.shape[0]
    cols = payload.shape[1] if payload.dim() == 2 else 0
    if not 1 <= cols <= SEGSUM_MAX_COLS:
        raise ValueError(f"plane_sums: payload must be [n, 1..{SEGSUM_MAX_COLS}]"
                         f", got {tuple(payload.shape)}")
    ids = _cuda_tensor(ids, torch.int32, (n,), "ids")
    payload = _cuda_tensor(payload, torch.float32, (n, cols), "payload")
    cap128 = ceil128(table_cap)
    bound = min(ceil128(n_live), cap128)
    dev = ids.device
    out = torch.zeros((cap128, cols), dtype=torch.float32, device=dev)
    if bound == 0 or n == 0:  # no live id or no row: nothing launched
        return out
    if bound >= FOLD_ID_LIMIT:
        raise ValueError(f"plane_sums: live bound {bound} not below "
                         f"{FOLD_ID_LIMIT}")
    nblk = -(-n // SEGSUM_ROWS)
    # written only where a block touches an id (flagged in ``touched``)
    partial = torch.empty((nblk, bound, cols), dtype=torch.float32,
                          device=dev)
    touched = torch.empty((nblk, bound), dtype=torch.uint8, device=dev)
    lib = _load()
    err = lib.bst_plane_sums(ids.data_ptr(), payload.data_ptr(), cols,
                             partial.data_ptr(), touched.data_ptr(),
                             out.data_ptr(), n, bound, _stream(out))
    _check(lib, err, "plane_sums")
    launch_counts["plane_sums"] += 1
    return out


def plane_adopt_cuda(payload, holes, table, rows, *, th_thickness, th_cos,
                     signed=False, init=None):
    """CUDA hole adoption (csrc/adopt.cu); see
    :func:`buildingsegment_tpu_torch.ops.adopt.plane_adopt`.  ``table``
    is the f32[10, 128] lane table of ``ops.adopt.adopt_table``."""
    n = holes.shape[0]
    payload = _cuda_tensor(payload, torch.float32, (n, 8), "payload")
    if payload.data_ptr() % 16:  # rows read as two float4s
        payload = payload.clone()
    table = _cuda_tensor(table, torch.float32, (10, ADOPT_LANES), "table")
    rows = _cuda_tensor(rows, torch.int32, (ADOPT_LANES,), "rows")
    holes_u8 = _mask_bytes(holes, n)
    dev = holes.device
    adopted = torch.empty(n, dtype=torch.bool, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    nblk = -(-n // ADOPT_ROWS)
    # one scratch allocation: the f32 [nblk, 128, 8] partials, written only
    # where a block adopted rows into a lane, flagged per block (bflag)
    # and, where that is set, per (block, lane) (lflag)
    part_bytes = nblk * ADOPT_LANES * 8 * 4
    scratch = torch.empty(part_bytes + nblk * (1 + ADOPT_LANES),
                          dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    if init is None:
        acc = torch.empty((ADOPT_LANES, 8), dtype=torch.float32, device=dev)
    else:
        # the reduce adds the block sums onto the lane rows already there
        acc = _cuda_tensor(init, torch.float32, (ADOPT_LANES, 8),
                           "init").clone()
    lib = _load()
    err = lib.bst_adopt(
        payload.data_ptr(), holes_u8.data_ptr(), table.data_ptr(),
        rows.data_ptr(), adopted.data_ptr(), row.data_ptr(), base,
        base + part_bytes, base + part_bytes + nblk, acc.data_ptr(), n,
        th_thickness, th_cos, int(signed), int(init is not None),
        _stream(row),
    )
    _check(lib, err, "plane_adopt")
    launch_counts["plane_adopt"] += 1
    return adopted, row, acc


#: largest query and candidate tiles of csrc/knn_exact.cu
KNN_MAX_QT = 128
KNN_MAX_CT = 1024
#: the warp design of csrc/knn_exact.cu (kTileQueries, kChunk,
#: kTileMaxKk): a one-warp block owns 64 queries of a query tile and
#: streams the candidates in chunks of 256; it keeps lists of at most 64
#: entries (k ≤ 65) and takes query tiles of a multiple of 64 rows and
#: candidate tiles of a multiple of 32; other shapes take the first
#: design's kernel, one thread a query, which computes the same function
KNN_TILE_QUERIES = 64
KNN_CHUNK = 256
KNN_TILE_MAX_KK = 64


def knn_exact_cuda(pos, seed_d, seed_i, visit, visit_d2, counts, *, qt, ct,
                   w_excl):
    """CUDA exact kNN scan (csrc/knn_exact.cu): the warp design up to
    ``KNN_TILE_MAX_KK`` list entries, else the first design's kernel; see
    :func:`buildingsegment_tpu_torch.ops.pallas_knn.knn_exact`."""
    n, kk = seed_d.shape
    if not (0 < qt <= KNN_MAX_QT and 0 < ct <= KNN_MAX_CT and n % qt == 0
            and n % ct == 0 and kk >= 1):
        raise ValueError(f"knn_exact: N={n} with query tile {qt}, candidate "
                         f"tile {ct}, k-1={kk} is not a supported shape")
    comps = [_f32(t, n, "pos") for t in pos]
    seed_d = _cuda_tensor(seed_d, torch.float32, (n, kk), "seed_d")
    seed_i = _cuda_tensor(seed_i, torch.int32, (n, kk), "seed_i")
    tiles = (n // qt, n // ct)
    visit = _cuda_tensor(visit, torch.int32, tiles, "visit")
    visit_d2 = _cuda_tensor(visit_d2, torch.float32, tiles, "visit_d2")
    counts = _cuda_tensor(counts, torch.int32, (n // qt,), "counts")
    out_d = torch.empty_like(seed_d)
    out_i = torch.empty_like(seed_i)
    # the warp design's float4 positions (invalid rows NaN)
    packed = torch.empty((n, 4), dtype=torch.float32, device=out_d.device)
    lib = _load()
    err = lib.bst_knn_exact(
        *[t.data_ptr() for t in comps], seed_d.data_ptr(), seed_i.data_ptr(),
        visit.data_ptr(), visit_d2.data_ptr(), counts.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), packed.data_ptr(), n, kk, qt,
        ct, int(w_excl), _stream(out_d),
    )
    _check(lib, err, "knn_exact")
    launch_counts["knn_exact"] += 1
    return out_d, out_i


#: most non-self kNN slots the graph solve's edge walk takes
#: (kGraphMaxSlots in csrc/graph_hop.cu): a point's lanes are a half-warp
#: up to 16 slots, a whole warp up to 32
GRAPH_MAX_SLOTS = 32


def _graph_walk_inputs(label, nb, nb_valid, models):
    """The checks both graph wrappers make; returns (label, nb, nb_valid,
    models) ready for the kernel."""
    n = label.shape[0]
    label = _cuda_tensor(label, torch.int32, (n,), "label")
    kk = nb.shape[1] if nb.dim() == 2 else 0
    if not 1 <= kk <= GRAPH_MAX_SLOTS:
        raise ValueError(f"graph walk: nb must be [n, 1..{GRAPH_MAX_SLOTS}]"
                         f", got {tuple(nb.shape)}")
    nb = _cuda_tensor(nb, torch.int32, (n, kk), "nb")
    nb_valid = _cuda_tensor(nb_valid, torch.bool, (n, kk), "nb_valid")
    models = _cuda_tensor(models, torch.float32, (models.shape[0], 8),
                          "models")
    if models.data_ptr() % 16:  # rows read as two float4s
        models = models.clone()
    return label, nb, nb_valid, models


def graph_hop_cuda(label, nb, nb_valid, points, models, *, th_thickness,
                   th_normal_cos, signed=False):
    """CUDA graph hop (csrc/graph_hop.cu): one walk of every point's kNN
    edges, an atomic only where a label falls; see
    :func:`buildingsegment_tpu_torch.ops.graph_hop.graph_hop`."""
    label, nb, nb_valid, models = _graph_walk_inputs(label, nb, nb_valid,
                                                     models)
    n, kk = nb.shape
    points = _cuda_tensor(points, torch.float32, (n, 8), "points")
    if points.data_ptr() % 16:  # rows read as two float4s
        points = points.clone()
    out = torch.empty_like(label)
    lib = _load()
    err = lib.bst_graph_hop(
        label.data_ptr(), nb.data_ptr(), nb_valid.data_ptr(),
        points.data_ptr(), models.data_ptr(), out.data_ptr(), n, kk,
        models.shape[0], th_thickness, th_normal_cos, int(signed),
        _stream(out))
    _check(lib, err, "graph_hop")
    launch_counts["graph_hop"] += 1
    return out


def graph_union_cuda(label, nb, nb_valid, models, *, th_thickness,
                     th_normal_cos, signed=False):
    """CUDA union hooks of the graph solve (csrc/graph_hop.cu, the hop's
    edge walk); see
    :func:`buildingsegment_tpu_torch.ops.graph_hop.graph_union_hooks`."""
    label, nb, nb_valid, models = _graph_walk_inputs(label, nb, nb_valid,
                                                     models)
    n, kk = nb.shape
    ng = models.shape[0]
    parent = torch.empty(ng, dtype=torch.int32, device=label.device)
    lib = _load()
    err = lib.bst_graph_union(
        label.data_ptr(), nb.data_ptr(), nb_valid.data_ptr(),
        models.data_ptr(), parent.data_ptr(), n, kk, ng, th_thickness,
        th_normal_cos, int(signed), _stream(parent))
    _check(lib, err, "graph_union")
    launch_counts["graph_union"] += 1
    return parent
