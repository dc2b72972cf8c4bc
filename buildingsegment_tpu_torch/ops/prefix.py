"""Integer prefix sum.

Port of ``buildingsegment_tpu/ops/prefix.py``, whose triangular-matmul
form exists only because a cumsum is slow on the TPU; integer cumsum is
exact and direct on both the CPU and the card.
"""

from __future__ import annotations

import torch

__all__ = ["prefix_sum_i32"]


def prefix_sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int[n] vector, as int32."""
    return torch.cumsum(x, 0, dtype=torch.int32)
