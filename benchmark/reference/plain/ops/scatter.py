# Frozen copy of buildingsegment_tpu_torch/ops/scatter.py at commit e8749d5,
# with every hand-written kernel call taken out: each call site runs
# the plain PyTorch version the port holds its kernel to.  The control's
# TF32 rounding (``precision.rp``) marks the operands of the sums.
"""Bilinear scatter-add rasterization — the ortho splat.

Port of ``buildingsegment_tpu/ops/scatter.py``, the replacement for the
reference's per-point 2×2 splat loop (tmc3/TMC3.cpp:132-148): every
point at or above the ground threshold deposits bilinear weights into a
(height × width) raster — weight into the density channel, weight × z
into the height channel.  In JAX this is an XLA scatter-add outside any
Pallas kernel; here it is one ``index_add_`` of the 4·N corner rows
into a [cells, 2] table (float atomics on the card, so the order of the
adds, and the last bits of a cell's sum, may change from run to run).

Semantics parity notes:
  * integer cell = floor(p/bin) via integer division on non-negative
    coords; fractional weight = p/bin − cell (tmc3/TMC3.cpp:134-142).
  * points below the threshold are skipped (the reference's ``continue``
    is inside the 2×2 loop but is equivalent to skipping the point,
    tmc3/TMC3.cpp:139-140); masked-out rows carry weight 0.
  * raster dims are (bbox_extent / bin + 2) (tmc3/TMC3.cpp:75-77) so
    the +1 corner never lands out of bounds; the clamp only keeps the
    zero-weight padding rows in range.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.precision import rp

__all__ = ["bilinear_splat"]


def bilinear_splat(
    positions: torch.Tensor,
    mask: torch.Tensor,
    z_threshold,
    *,
    width: int,
    height: int,
    bin_size: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Splat points into (density, height_sum) rasters.

    Args:
        positions: int32[N, 3], non-negative (bbox-shifted) coords.
        mask: bool[N].
        z_threshold: int or 0-d tensor — points with z < threshold are
            skipped (the ground filter, tmc3/TMC3.cpp:139).
        width/height/bin_size: raster geometry.

    Returns:
        (density float32[height, width], height_sum float32[height, width])
        — the reference's channel 1 and channel 0 respectively
        (tmc3/TMC3.cpp:144-145).
    """
    pos = positions
    keep = mask & (pos[:, 2] >= z_threshold)

    cx = pos[:, 0] // bin_size
    cy = pos[:, 1] // bin_size
    fx = pos[:, 0].float() / bin_size - cx.float()
    fy = pos[:, 1].float() / bin_size - cy.float()

    wm = keep.float()
    z = pos[:, 2].float()

    # corner weights: (xi, yi) ∈ {0,1}² with s = wx(xi) * wy(yi)
    w00 = (1.0 - fx) * (1.0 - fy) * wm
    w10 = fx * (1.0 - fy) * wm
    w01 = (1.0 - fx) * fy * wm
    w11 = fx * fy * wm

    def flat(x, y):
        return (y.clamp(0, height - 1) * width + x.clamp(0, width - 1)).long()

    idx = torch.cat([flat(cx, cy), flat(cx + 1, cy), flat(cx, cy + 1),
                     flat(cx + 1, cy + 1)])
    w = torch.cat([w00, w10, w01, w11])
    rows = torch.stack([w, rp(w) * rp(z.repeat(4))], 1)
    table = torch.zeros((height * width, 2), dtype=torch.float32,
                        device=pos.device)
    table.index_add_(0, idx, rp(rows))
    return (table[:, 0].reshape(height, width),
            table[:, 1].reshape(height, width))
