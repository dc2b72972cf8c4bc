"""PointBatch — the padded device point container of the port.

Port of the upload half of ``buildingsegment_tpu/core/pointset.py``:
positions padded to a fixed capacity with a far-away sentinel, and a
validity mask.  The segmentation path reads positions and mask only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["PointBatch", "PAD_COORD"]

#: sentinel coordinate of padding rows: far from every real point, small
#: enough that squared distances stay finite in float32
PAD_COORD = 2**24


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """positions int32[C, 3] (rows ≥ count hold ``PAD_COORD``) and
    mask bool[C] on one device."""

    positions: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @staticmethod
    def upload(
        positions: np.ndarray,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "PointBatch":
        """Pad host int32[N, 3] positions to ``capacity`` rows and copy
        them to ``device``."""
        n = positions.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        pos = np.full((cap, 3), PAD_COORD, np.int32)
        pos[:n] = positions.astype(np.int32)
        mask = np.zeros(cap, bool)
        mask[:n] = True
        return PointBatch(
            positions=torch.from_numpy(pos).to(device),
            mask=torch.from_numpy(mask).to(device),
        )
