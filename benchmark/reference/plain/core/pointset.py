# Frozen copy of buildingsegment_tpu_torch/core/pointset.py at commit e8749d5,
# with every hand-written kernel call taken out: each call site runs
# the plain PyTorch version the port holds its kernel to.
"""PointBatch — the padded device point container of the port.

Port of ``buildingsegment_tpu/core/pointset.py`` (the reference's
``PCCPointSet3`` struct of arrays, tmc3/PCCPointSet.h:64-614): positions
``int32[C, 3]`` padded to a fixed capacity with a far-away sentinel, a
validity mask, and the optional per-point attributes — colors
``uint16[C, 3]`` in the internal (g, b, r) order (tmc3/ply.cpp:412-414),
the plane label ``int32[C]`` (−1 = unlabeled, tmc3/my_function.h:103),
reflectance, frame index and laser angle.  Every reorder moves all of
them together, so an attribute cannot come apart from its point.

A batch lives on one device: ``from_numpy``, ``from_host_cloud`` and
``upload`` take the device (the card unless the caller asks for the
CPU), every transform keeps the batch's.  The segmentation path reads
positions and mask only (``upload``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["PointBatch", "PAD_COORD", "UNLABELED"]

#: sentinel coordinate of padding rows: far from every real point, small
#: enough that squared distances stay finite in float32
PAD_COORD = 2**24
#: the label of a point no plane holds (tmc3/my_function.h:103)
UNLABELED = -1

_ATTRS = ("colors", "plane_idx", "reflectances", "frame_idx", "laser_angles")


def _padded(positions: np.ndarray, capacity: Optional[int]):
    """Host int32[N, 3] positions padded to ``capacity`` rows with
    ``PAD_COORD``, and the validity mask."""
    n = positions.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    pos = np.full((cap, 3), PAD_COORD, np.int32)
    pos[:n] = positions.astype(np.int32)
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pos, mask


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """positions int32[C, 3] (rows ≥ count hold ``PAD_COORD``), mask
    bool[C], and the optional attributes (padding rows 0; ``plane_idx``
    −1), all on one device."""

    positions: torch.Tensor
    mask: torch.Tensor
    colors: Optional[torch.Tensor] = None
    plane_idx: Optional[torch.Tensor] = None
    reflectances: Optional[torch.Tensor] = None
    frame_idx: Optional[torch.Tensor] = None
    laser_angles: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def count(self) -> torch.Tensor:
        """Number of real points (an int32 scalar on the batch's device)."""
        return self.mask.sum(dtype=torch.int32)

    def has_colors(self) -> bool:
        return self.colors is not None

    # construction

    @staticmethod
    def from_numpy(
        positions: np.ndarray,
        colors: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        reflectances: Optional[np.ndarray] = None,
        frame_idx: Optional[np.ndarray] = None,
        laser_angles: Optional[np.ndarray] = None,
        *,
        device="cuda",
    ) -> "PointBatch":
        """Pad host arrays to ``capacity`` rows and copy them to
        ``device``; every row starts unlabeled."""
        n = positions.shape[0]
        pos, mask = _padded(positions, capacity)
        cap = pos.shape[0]

        def pad(a, dtype):
            if a is None:
                return None
            out = np.zeros((cap,) + a.shape[1:], dtype)
            out[:n] = a.astype(dtype)
            return torch.from_numpy(out).to(device)

        return PointBatch(
            positions=torch.from_numpy(pos).to(device),
            mask=torch.from_numpy(mask).to(device),
            colors=pad(colors, np.uint16),
            plane_idx=torch.full((cap,), UNLABELED, dtype=torch.int32,
                                 device=device),
            reflectances=pad(reflectances, np.uint16),
            frame_idx=pad(frame_idx, np.uint8),
            laser_angles=pad(laser_angles, np.int32),
        )

    @staticmethod
    def upload(
        positions: np.ndarray,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "PointBatch":
        """Positions only: pad host int32[N, 3] positions to ``capacity``
        rows and copy them to ``device`` (the attributes stay None)."""
        pos, mask = _padded(positions, capacity)
        return PointBatch(
            positions=torch.from_numpy(pos).to(device),
            mask=torch.from_numpy(mask).to(device),
        )

    @staticmethod
    def from_host_cloud(cloud, capacity: Optional[int] = None, *,
                        device="cuda") -> "PointBatch":
        """From an :class:`io.ply.HostPointCloud`, every attribute
        included."""
        return PointBatch.from_numpy(
            cloud.positions,
            colors=cloud.colors,
            capacity=capacity,
            reflectances=cloud.reflectances,
            frame_idx=cloud.frame_idx,
            laser_angles=cloud.laser_angles,
            device=device,
        )

    # transforms (the batch's device)

    def with_positions(self, positions: torch.Tensor) -> "PointBatch":
        return dataclasses.replace(self, positions=positions)

    def with_colors(self, colors: torch.Tensor) -> "PointBatch":
        return dataclasses.replace(self, colors=colors)

    def with_plane_idx(self, plane_idx: torch.Tensor) -> "PointBatch":
        return dataclasses.replace(self, plane_idx=plane_idx)

    def gather(self, order: torch.Tensor) -> "PointBatch":
        """Reorder every per-point array by ``order`` (e.g. a Morton
        sort)."""
        def g(a):
            return None if a is None else a[order]

        return PointBatch(
            positions=self.positions[order],
            mask=self.mask[order],
            **{name: g(getattr(self, name)) for name in _ATTRS},
        )

    def dedup_quantized(self, min_geom_node_size_log2: int = 0) -> "PointBatch":
        """Mask out duplicate quantized positions (the reference's
        ``removeDuplicatePointInQuantizedPoint``, tmc3/PCCPointSet.h:
        457-472): valid positions lose their ``min_geom_node_size_log2``
        low bits, then every later duplicate leaves the mask
        (:func:`core.quantize.dedup_quantized`).

        As in the JAX package, two departures from the C++: duplicates go
        globally, the first in index order surviving (``std::unique``
        without a sort removes only adjacent ones), and the whole row is
        masked, so no attribute comes apart from its point.
        """
        from benchmark.reference.plain.core.quantize import dedup_quantized

        pos = self.positions
        if min_geom_node_size_log2 > 0:
            bits = -1 << min_geom_node_size_log2
            pos = torch.where(self.mask[:, None], pos & bits, pos)
        keep = dedup_quantized(pos, self.mask)
        return dataclasses.replace(self, positions=pos, mask=keep)

    # host export

    def to_numpy(self) -> dict:
        """The valid rows of every array, copied to host numpy."""
        mask = self.mask.cpu().numpy()
        out = {"positions": self.positions.cpu().numpy()[mask]}
        for name in _ATTRS:
            v = getattr(self, name)
            if v is not None:
                out[name] = v.cpu().numpy()[mask]
        return out
