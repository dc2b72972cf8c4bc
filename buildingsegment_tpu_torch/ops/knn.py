"""Exact k-nearest-neighbour graphs: the Morton-window seed pass and the
tiled brute force.

Port of ``knn_window_sorted``, ``_DUAL_SHIFT`` and ``knn`` from
``buildingsegment_tpu/ops/knn.py`` (the replacement for the reference's
Open3D ``KDTreeFlann::SearchKNN`` loop, tmc3/my_function.h:71-78).  As in
the reference, slot 0 of each list is the query itself; padded rows
never appear as neighbours of valid rows and their own lists are
all-self.

``knn_window_sorted`` ranks the ±window candidates of an already
Morton-sorted cloud (the seeds and the τ bound of the exact kernel,
``ops/pallas_knn.py``).  ``knn`` is the brute force that
``knn_method="auto"`` runs at capacity ≤ 65,536: the |q|² − 2q·c + |c|²
expansion in fp32 ranks a running top-(k−1+8) over candidate tiles, for
every query at once, and an exact diff-form pass re-ranks those
survivors.  The cross term q·c is written out as three products, not a
``torch.matmul``, so no process-wide TF32 setting can reach it (with
|q|² near 1e8 mm², TF32's error on q·c dwarfs a neighbour's d², and the
re-rank cannot bring back a neighbour the ranking dropped).  It has no
TPU kernel, so it stays plain PyTorch on the card.

Ties.  Coordinates are integer mm, so equal distances are common.  The
window ranking sorts stably in slot order (JAX's ``top_k`` rule; slots
run in index order), and the brute re-rank orders by (d², index), so a
result does not depend on the device.  Both packages center on the
masked mean before squaring; here the mean is taken in float64 and
rounded once, to whole mm (:func:`masked_center`), so it does not depend
on the order of summation (JAX's f32 sum does at 10^5 rows) and the
centered coordinates of an integer cloud stay exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buildingsegment_tpu_torch.ops.fused import _windows, window_neighbors

__all__ = [
    "knn",
    "knn_window_sorted",
    "masked_center",
    "order_key",
    "split_key",
    "DUAL_SHIFT",
]

#: per-axis translation of the second Morton order (the JAX package's
#: ``_DUAL_SHIFT``): alternating-bit constants move every power-of-two
#: cell boundary at every scale
DUAL_SHIFT = (0xAAA, 0x555, 0x924)
_PAD = -3e7
# rows per tile of the window ranking (bounds the [T, 2W] blocks; every
# result is per row, so the tiling does not change any value)
_TILE_ROWS = 1 << 18
# candidates per step of the brute force's running top-(k−1+margin), and
# the extra candidates it keeps for the exact re-rank
_CAND_TILE = 1024
_REFINE_MARGIN = 8


def masked_center(positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """f32[3] mean of the valid rows, summed in float64 (integer
    coordinates sum exactly there, in any order) and rounded once, to
    the nearest integer: centered integer coordinates stay integers, so
    every diff-form d² below 2^24 is exact."""
    m = mask[:, None]
    total = torch.where(m, positions, 0).to(torch.float64).sum(0)
    count = torch.clamp_min(mask.to(torch.float64).sum(), 1.0)
    return torch.round(total / count).to(torch.float32)


def order_key(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 key that orders by (d, idx) for d ≥ 0 (or +inf) f32 and
    idx in [0, 2^31): non-negative floats order as their bit patterns."""
    bits = d.contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | idx.to(torch.int64)


def split_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`order_key` → (d f32, idx int32)."""
    d = (key >> 32).to(torch.int32).view(torch.float32)
    return d, (key & 0xFFFFFFFF).to(torch.int32)


def knn_window_sorted(
    spos: torch.Tensor,
    smask: torch.Tensor,
    k: int,
    *,
    window: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN over a ±window of an already Morton-sorted cloud.

    Args:
        spos: float32[N, 3] positions in Morton order.
        smask: bool[N].
        k: neighbours per point INCLUDING self at slot 0.
        window: half-width (2·window ≥ k − 1).

    Returns (indices int32[N, k] in the sorted frame, squared distances
    f32[N, k]); slot 0 = self; empty slots fall back to self at 0.
    """
    n = spos.shape[0]
    if 2 * window < k - 1:
        raise ValueError(f"window {window} too small for k={k}")
    dev = spos.device
    fill = torch.full((window,), _PAD, dtype=torch.float32, device=dev)
    comps = [torch.cat([fill, spos[:, d].float(), fill]) for d in range(3)]
    off = torch.zeros(window, dtype=torch.bool, device=dev)
    pmask = torch.cat([off, smask, off])
    nb_d = torch.empty((n, k - 1), dtype=torch.float32, device=dev)
    arg = torch.empty((n, k - 1), dtype=torch.int64, device=dev)
    for r0 in range(0, n, _TILE_ROWS):
        r1 = min(n, r0 + _TILE_ROWS)
        dx, dy, dz = (
            _windows(c, window, r0, r1) - spos[r0:r1, d].float()[:, None]
            for d, c in enumerate(comps)
        )
        d = dx * dx + dy * dy + dz * dz
        valid = _windows(pmask, window, r0, r1) & smask[r0:r1, None]
        d = torch.where(valid, d, torch.inf)
        srt, sarg = torch.sort(d, dim=1, stable=True)
        nb_d[r0:r1] = srt[:, : k - 1]
        arg[r0:r1] = sarg[:, : k - 1]
    return window_neighbors(nb_d, arg, smask, window)


def knn(
    positions: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force kNN graph.

    Args:
        positions: int32/float [N, 3].
        mask: bool[N] validity.
        k: neighbours per point INCLUDING self at slot 0.

    Returns (indices int32[N, k], squared distances f32[N, k]); slot 0 is
    self at 0, then the nearest others ascending by (d², index); slots a
    valid row cannot fill, and every slot of a masked row, are self at 0.
    """
    n = positions.shape[0]
    dev = positions.device
    kk = k - 1
    kr = kk + _REFINE_MARGIN
    pos = positions.float() - masked_center(positions, mask)
    # padded rows: a far sentinel, and masked to +inf as candidates
    pos = torch.where(mask[:, None], pos, 3e7)
    sq = pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1] + pos[:, 2] * pos[:, 2]
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    best_d = torch.full((n, kr), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n, kr), dtype=torch.int64, device=dev)
    for c0 in range(0, n, _CAND_TILE):
        c1 = min(n, c0 + _CAND_TILE)
        c = pos[c0:c1]
        dot = (pos[:, None, 0] * c[None, :, 0] + pos[:, None, 1] * c[None, :, 1]
               + pos[:, None, 2] * c[None, :, 2])
        d = sq[:, None] - 2.0 * dot + sq[None, c0:c1]
        cidx = rows[c0:c1]
        d = torch.where((cidx[None, :] == rows[:, None]) | ~mask[None, c0:c1],
                        torch.inf, d)
        all_d = torch.cat([best_d, d], 1)
        all_i = torch.cat([best_i, cidx.expand(n, -1)], 1)
        best_d, sel = torch.topk(all_d, kr, dim=1, largest=False)
        best_i = torch.gather(all_i, 1, sel)

    # exact diff-form re-rank of the survivors (the expansion cancels at
    # mm scale and can misrank near-ties), ordered by (d², index)
    diff = pos[best_i] - pos[:, None, :]
    d_ex = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            + diff[..., 2] * diff[..., 2])
    d_ex = torch.where(torch.isinf(best_d), torch.inf, d_ex)
    nb_d, nb_i = split_key(torch.sort(order_key(d_ex, best_i), dim=1)
                           .values[:, :kk])
    self_i = rows[:, None].to(torch.int32)
    empty = torch.isinf(nb_d) | ~mask[:, None]
    nb_i = torch.cat([self_i, torch.where(empty, self_i, nb_i)], 1)
    nb_d = torch.cat([torch.zeros_like(self_i, dtype=torch.float32),
                      torch.where(empty, 0.0, nb_d)], 1)
    return nb_i, nb_d
