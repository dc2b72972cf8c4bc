"""Bounding-box shift and the host-side quantization helpers.

Port of ``buildingsegment_tpu/core/quantize.py``.  ``shift_to_origin``
is the device op (tmc3/TMC3.cpp:58-72, "shift to positive"); the numpy
helpers feed the pipeline's static hints and the opt-in dedup.  They are
copies, not imports: the JAX module imports jax at the top.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "compute_bbox",
    "shift_to_origin",
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
