"""Build, load and launch the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``
(pointers and the stream passed as ``c_void_p``).  The library lands in
``_build/`` next to this file, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.

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
import time
from typing import Optional

import torch

__all__ = [
    "build",
    "launch_counts",
    "reset_launch_counts",
    "label_sweep_cuda",
    "compact_sweep_cuda",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_SOURCES = ("label_sweep.cu", "compact_sweep.cu")
_HEADERS = ("sweep_common.cuh",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

#: kernel name → number of launches since the last reset
launch_counts = {"label_sweep": 0, "compact_sweep": 0}

_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [os.path.join(_CSRC, s) for s in _SOURCES]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr, file=sys.stderr)
    os.replace(tmp, path)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(_library_path())
    lib.bst_error_string.argtypes = [_I]
    lib.bst_error_string.restype = ctypes.c_char_p
    lib.bst_label_sweep.argtypes = [_P] * 16 + [_I, _I, _F, _F, _F, _I, _I, _P]
    lib.bst_label_sweep.restype = _I
    lib.bst_compact_sweep.argtypes = (
        [_P] * 20 + [_I] * 4 + [_F] * 5 + [_I] * 3 + [_P]
    )
    lib.bst_compact_sweep.restype = _I
    _lib = lib
    return lib


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


def label_sweep_cuda(
    pos, nrm, model_n, model_c, label, mask, *, w, th_thickness,
    th_normal_cos, edge_gate2, inf_label, signed=False,
):
    """CUDA ``label_sweep`` (csrc/label_sweep.cu); see
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


def compact_sweep_cuda(
    pos, nrm, cnrm, mask, clabel, anchor, bound, *, lc, w, th_thickness,
    th_normal_cos, edge_gate2, root_gate, th_anchor_cos, anchor_gate,
    signed=False, jump_rounds=2,
):
    """CUDA ``compact_sweep`` (csrc/compact_sweep.cu); see
    :func:`buildingsegment_tpu_torch.ops.compact_sweep.compact_sweep`."""
    n = clabel.shape[0]
    if clabel.dtype != torch.int32 or not clabel.is_cuda:
        raise ValueError("clabel: need a CUDA int32 tensor")
    if not 1 <= bound <= lc:
        raise ValueError(f"slot bound {bound} outside [1, {lc}]")
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
        mtab.data_ptr(), ptab.data_ptr(), parent.data_ptr(),
        hop.data_ptr(), out.data_ptr(), counters.data_ptr(),
        n, w, lc, int(bound), th_thickness, th_normal_cos, edge_gate2,
        th_anchor_cos, root_gate, int(anchor_gate),
        int(signed), jump_rounds, _stream(clabel),
    )
    _check(lib, err, "compact_sweep")
    launch_counts["compact_sweep"] += 1
    return out, counters
