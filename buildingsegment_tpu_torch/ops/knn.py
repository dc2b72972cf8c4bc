"""Exact k-nearest-neighbour graphs: the Morton-window seed pass and the
tiled brute force.

Port of ``knn_window_sorted``, ``knn_window``, ``window_offsets``,
``_DUAL_SHIFT`` and ``knn`` from ``buildingsegment_tpu/ops/knn.py`` (the
replacement for the reference's Open3D ``KDTreeFlann::SearchKNN`` loop,
tmc3/my_function.h:71-78).  As in the reference, slot 0 of each list is
the query itself; padded rows never appear as neighbours of valid rows
and their own lists are all-self.

``knn_window_sorted`` ranks the ±window candidates of an already
Morton-sorted cloud (the seeds and the τ bound of the exact kernel,
``ops/pallas_knn.py``).  ``knn_window`` is the approximate kNN of any
cloud: the window search along its Morton order, unioned with a second
search along the Morton order of a translated copy (``DUAL_SHIFT``), in
the input frame; no pipeline path calls it.  ``knn`` is the brute force that
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
run in index order), and the brute re-rank and the union of
``knn_window`` order by (d², index), so a result does not depend on the
device.  Both packages center on the
masked mean before squaring; here the mean is taken in float64 and
rounded once, to whole mm (:func:`masked_center`), so it does not depend
on the order of summation (JAX's f32 sum does at 10^5 rows) and the
centered coordinates of an integer cloud stay exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buildingsegment_tpu_torch.core.morton import morton_argsort
from buildingsegment_tpu_torch.ops.fused import _windows, window_neighbors

__all__ = [
    "knn",
    "knn_window",
    "knn_window_sorted",
    "window_offsets",
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


def window_offsets(window: int, device="cpu") -> torch.Tensor:
    """Candidate offsets [−W..−1, 1..W] (self excluded), int32[2W]."""
    return torch.cat([torch.arange(-window, 0, device=device),
                      torch.arange(1, window + 1, device=device)]).to(
                          torch.int32)


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


def knn_window(
    positions: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    window: int = 32,
    presorted: bool = False,
    dual: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN by ±window searches in Morton order.

    Args:
        positions: int32[N, 3] (non-negative; the pipeline shifts the
            cloud to the origin).
        mask: bool[N].
        k: neighbours per point INCLUDING self at slot 0.
        window: half-width of each search.
        presorted: the input is Morton-sorted already; the first search
            runs in place and the result stays in that frame.
        dual: union a second search along the Morton order of the cloud
            translated by :data:`DUAL_SHIFT` (the JAX package measured
            recall 0.84 → 0.99 at W = 64).

    Returns (indices int32[N, k] in the input frame, squared distances
    f32[N, k]); slot 0 = self, then the nearest distinct candidates of
    both searches by (d², index); empty slots and masked rows → self at 0.
    """
    n = positions.shape[0]
    dev = positions.device
    self_idx = torch.arange(n, dtype=torch.int64, device=dev)

    def one_pass(order):
        """Window kNN along ``order``, ids mapped back to the input
        frame."""
        nb_sorted, nb_d = knn_window_sorted(
            positions[order].float(), mask[order], k, window=window)
        out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
        out_i[order] = order[nb_sorted.long()].to(torch.int32)
        out_d[order] = nb_d
        return out_i, out_d

    if presorted:
        i1, d1 = knn_window_sorted(positions.float(), mask, k, window=window)
        if not dual:
            return i1, d1
    else:
        i1, d1 = one_pass(morton_argsort(positions, mask))

    if dual:
        shift = torch.tensor(DUAL_SHIFT, dtype=positions.dtype, device=dev)
        i2, d2 = one_pass(morton_argsort(positions + shift, mask))
        # the union without slot 0 (self, restored below); an entry that
        # fell back to self (too few valid peers in that search) must not
        # enter it with d = 0
        cand_i = torch.cat([i1[:, 1:], i2[:, 1:]], 1)
        cand_d = torch.cat([d1[:, 1:], d2[:, 1:]], 1)
        cand_d = torch.where(cand_i == self_idx[:, None], torch.inf, cand_d)
        # a candidate both searches found has the same d² in each, so its
        # copies sit side by side in (d², index) order: drop the later
        key = torch.sort(order_key(cand_d, cand_i), dim=1).values
        s_d, s_i = split_key(key)
        dup = torch.zeros_like(s_i, dtype=torch.bool)
        dup[:, 1:] = s_i[:, 1:] == s_i[:, :-1]
        s_d = torch.where(dup, torch.inf, s_d)
        nb_d, nb_i = split_key(torch.sort(order_key(s_d, s_i), dim=1)
                               .values[:, : k - 1])
        invalid = torch.isinf(nb_d)
        self_i = self_idx[:, None].to(torch.int32)
        nb_i = torch.where(invalid, self_i, nb_i)
        nb_d = torch.where(invalid, 0.0, nb_d)
        out_i = torch.cat([self_i, nb_i], 1)
        out_d = torch.cat([torch.zeros_like(nb_d[:, :1]), nb_d], 1)
    else:
        out_i, out_d = i1, d1

    out_i = torch.where(mask[:, None], out_i,
                        self_idx[:, None].to(torch.int32))
    out_d = torch.where(mask[:, None], out_d, 0.0)
    return out_i, out_d


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
