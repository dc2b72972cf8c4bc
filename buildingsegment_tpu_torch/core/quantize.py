"""Bounding-box shift and the host-side quantization helpers.

Port of ``buildingsegment_tpu/core/quantize.py``.  ``shift_to_origin``
is the device op (tmc3/TMC3.cpp:58-72, "shift to positive");
``quantize_positions`` and ``dedup_quantized`` are the device forms of
the PLY quantization and the container dedup; the numpy helpers feed
the pipeline's static hints and the opt-in dedup.  They are copies, not
imports: the JAX module imports jax at the top.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "compute_bbox",
    "shift_to_origin",
    "quantize_positions",
    "dedup_quantized",
    "dedup_keep_mask",
    "estimate_spacing_mm",
    "spacing_bucket_mm",
]

_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


def compute_bbox(
    positions: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked integer bounding box (min, max), each int32[3]
    (tmc3/TMC3.cpp:58-68: min starts at int32 max, max at int32 min)."""
    m = mask[:, None]
    lo = torch.where(m, positions, _I32_MAX).amin(dim=0)
    hi = torch.where(m, positions, _I32_MIN).amax(dim=0)
    return lo, hi


def shift_to_origin(
    positions: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Translate so the bbox min is the origin (tmc3/TMC3.cpp:70-72).

    Returns (shifted int32[N,3], bbox_min int32[3], bbox_max int32[3]);
    padded rows keep their coordinates.
    """
    lo, hi = compute_bbox(positions, mask)
    shifted = torch.where(mask[:, None], positions - lo[None, :], positions)
    return shifted, lo, hi


def quantize_positions(raw: torch.Tensor, scale: float) -> torch.Tensor:
    """float[N, 3] × scale, truncated toward zero → int32[N, 3] (C++
    double→int32 conversion, tmc3/ply.cpp:407-409).  float64 input is
    scaled in float64, anything else in float32."""
    dtype = torch.float64 if raw.dtype == torch.float64 else torch.float32
    return torch.trunc(raw.to(dtype) * scale).to(torch.int32)


def dedup_quantized(
    positions: torch.Tensor, mask: torch.Tensor, drop_bits: int = 0
) -> torch.Tensor:
    """Validity mask with later duplicates cleared, positions compared
    after dropping ``drop_bits`` low bits; the FIRST occurrence in index
    order survives (tmc3/PCCPointSet.h:457-472).

    The key is the JAX package's: the two 30-bit Morton words of the
    clamped (≥ 0) coordinates, so coordinates that alias in those words
    (≥ 2^20 after the drop) alias here too.  One stable sort of the
    int64 key ``hi << 30 | lo`` (masked rows carry hi = 2^31 − 1 and sort
    last) gives JAX's two-pass order.
    """
    from buildingsegment_tpu_torch.core.morton import morton_encode

    q = torch.where(mask[:, None], positions >> drop_bits, -1)
    q = torch.clamp_min(q, 0)
    lo = morton_encode(q, shift=0).to(torch.int64)
    hi = torch.where(mask, morton_encode(q, shift=10), _I32_MAX)
    order = torch.sort((hi.to(torch.int64) << 30) | lo, stable=True).indices
    s_lo, s_hi, s_mask = lo[order], hi[order], mask[order]
    same_as_prev = torch.zeros_like(s_mask)
    same_as_prev[1:] = ((s_lo[1:] == s_lo[:-1]) & (s_hi[1:] == s_hi[:-1])
                        & s_mask[1:])
    keep = torch.zeros_like(mask)
    keep[order] = s_mask & ~same_as_prev
    return keep


def dedup_keep_mask(positions: np.ndarray, drop_bits: int = 0) -> np.ndarray:
    """Host keep mask for quantized-duplicate removal: positions compared
    after dropping ``drop_bits`` low bits, the FIRST occurrence in index
    order survives (tmc3/PCCPointSet.h:457-472)."""
    n = len(positions)
    if n == 0:
        return np.zeros(0, bool)
    q = positions.astype(np.int64) >> drop_bits
    q = q - q.min(axis=0, keepdims=True)
    if int(q.max()) < (1 << 21):
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        _, first = np.unique(key, return_index=True)
    else:  # pragma: no cover — >2 km extent at mm scale
        _, first = np.unique(q, axis=0, return_index=True)
    keep = np.zeros(n, bool)
    keep[first] = True
    return keep


def estimate_spacing_mm(positions: np.ndarray, cell_mm: int = 512) -> float:
    """Point spacing of a surface scan (mm) from voxel occupancy:
    points per occupied ``cell_mm`` cell ≈ (cell / spacing)²."""
    n = len(positions)
    if n == 0:
        return float(cell_mm)
    q = positions.astype(np.int64)
    q = (q - q.min(axis=0, keepdims=True)) // cell_mm
    if int(q.max(initial=0)) < (1 << 21):
        key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
        occupied = len(np.unique(key))
    else:  # pragma: no cover — >~1000 km extent at cell=512
        occupied = len(np.unique(q, axis=0))
    per = n / max(occupied, 1)
    return float(cell_mm) / max(per, 1.0) ** 0.5


def spacing_bucket_mm(est_mm: float) -> float:
    """Nearest power of two (mm), clamped to [16, 2048]."""
    return float(min(max(2 ** round(math.log2(max(est_mm, 16.0))), 16), 2048))
