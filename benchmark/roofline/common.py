"""Counting helpers shared by the kernels' work counts (copied from
``chip_smoke.py`` at commit e8749d5)."""

import torch


def nbytes(xs) -> int:
    """Bytes of the tensors in ``xs`` (nested tuples and lists)."""
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            total += nbytes(x)
    return total


def window_pairs(mask: torch.Tensor, w: int) -> int:
    """Valid (row, candidate) pairs of a ±w window: the candidate tests a
    window kernel must make on these inputs."""
    m = mask.to(torch.int64)
    c = torch.cumsum(torch.cat([m.new_zeros(1), m]), 0)
    n = m.shape[0]
    i = torch.arange(n, device=m.device)
    lo, hi = (i - w).clamp(0, n), (i + w + 1).clamp(0, n)
    return int(((c[hi] - c[lo] - m) * m).sum())
