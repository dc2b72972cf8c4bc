"""Exact brute-force kNN with box-pruned candidate tiles (kernel #14).

Port of ``knn_pallas`` from ``buildingsegment_tpu/ops/pallas_knn.py``
(``knn_method="pallas"``, the exact-kNN path; the module keeps its name
so the counterpart is easy to find).  Three parts:

1. :func:`_prepare`, plain PyTorch: center the cloud (invalid rows at
   the −3e7 sentinel), seed every query's list with its Morton-window
   kNN (``ops/knn.knn_window_sorted`` at window ``w_excl = max(32, k)``),
   bound each query's k-th distance from above by the better of that
   window and a second window over a translated Morton order, and list
   for each 128-query tile the 1024-candidate tiles in increasing
   box-to-box distance, with the count whose box distance is ≤ the
   tile's largest bound (``<=``, so a neighbour on a box corner at the
   final k-th distance is never skipped).
2. :func:`knn_exact`: per query, the k−1 nearest candidates outside the
   rank window (|c − q| > w_excl — those are the seeds' territory),
   merged with the seeds.  A CUDA tensor launches ``csrc/knn_exact.cu``,
   which visits only the listed tiles whose box bound is ≤ the tile's
   running τ; a CPU tensor runs :func:`knn_exact_reference`, the brute
   force over every candidate, which takes no pruning.  Both keep the
   k−1 smallest of seeds ∪ candidates by (d², index) and return each
   row in that order, so they agree bit for bit; the pruning is exact
   (a box bound is a lower bound on every pair distance it covers), so
   the result is the exact kNN.
3. :func:`_finish`: empty slots and masked rows become self, self is
   prepended.

:func:`knn_pallas` puts a span (``profiling.annotate``) around part 1,
``knn.prepare``, and around the #14 launch, ``knn.exact``; with
``tiles`` it hands back, on the device, the candidate tiles the query
tiles listed (Σ ``counts``), for its caller to read after its
synchronize.

Not ported: the opt-in VMEM-resident kernel variant (``_kernel_resident``,
``BST_KNN_RESIDENT``) computes the same function and the tests hold the
plain version against it; ``static_rounds``, ``max_visits`` and the
inexact ``BST_KNN_VCAP`` probe are TPU perf knobs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.core.morton import morton_argsort
from buildingsegment_tpu_torch.ops.knn import (
    DUAL_SHIFT,
    knn_window_sorted,
    masked_center,
    order_key,
    split_key,
)
from buildingsegment_tpu_torch.profiling import annotate

__all__ = ["knn_pallas", "knn_exact", "knn_exact_reference"]

# rows of a query tile and of a candidate tile (each halved, down to 8,
# until it divides N), and the half-window of the seeding pass
QUERY_TILE = 128
CAND_TILE = 1024
SEED_WINDOW = 32
# sentinel coordinate of invalid rows, and the validity test on it
_SENTINEL = -3e7
_VALID_GT = -1e7
# distances at or above this are empty slots
_SENTINEL_D = 1e14
_KEY_NONE = torch.iinfo(torch.int64).max
# query rows × candidates per step of the plain version
_REF_QUERIES = 4096
_REF_CANDS = 2048


def knn_exact_reference(
    pos, seed_d, seed_i, visit, visit_d2, counts, *, qt, ct, w_excl,
    rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_exact`: brute force over every
    candidate, no pruning (``visit``, ``visit_d2``, ``counts``, ``qt`` and
    ``ct`` are the kernel's and are not read).  ``rows`` (int64) limits
    the queries to those rows; the result then has one row per entry."""
    px, py, pz = pos
    n = px.shape[0]
    kk = seed_d.shape[1]
    dev = px.device
    cand = torch.arange(n, dtype=torch.int64, device=dev)
    queries = cand if rows is None else rows.to(torch.int64)
    cvalid = px > _VALID_GT
    keys = []
    for q0 in range(0, queries.shape[0], _REF_QUERIES):
        q = queries[q0:q0 + _REF_QUERIES]
        key = order_key(seed_d[q], seed_i[q])
        qx, qy, qz = px[q, None], py[q, None], pz[q, None]
        qvalid = qx > _VALID_GT
        for c0 in range(0, n, _REF_CANDS):
            c1 = min(n, c0 + _REF_CANDS)
            dx = qx - px[None, c0:c1]
            dy = qy - py[None, c0:c1]
            dz = qz - pz[None, c0:c1]
            d = dx * dx + dy * dy + dz * dz
            ok = (((cand[None, c0:c1] - q[:, None]).abs() > w_excl)
                  & cvalid[None, c0:c1] & qvalid)
            ck = torch.where(
                ok, order_key(d, cand[None, c0:c1].expand(q.shape[0], -1)),
                _KEY_NONE)
            key = torch.topk(torch.cat([key, ck], 1), kk, dim=1,
                             largest=False, sorted=True).values
        keys.append(key)
    return split_key(torch.cat(keys))


def knn_exact(pos, seed_d, seed_i, visit, visit_d2, counts, *, qt, ct,
              w_excl):
    """The exact scan of #14 → (d² f32[N, k−1], indices int32[N, k−1]),
    each row ascending by (d², index).

    ``pos``: (x, y, z) f32[N] centered, invalid rows at −3e7;
    ``seed_d``/``seed_i``: f32/int32[N, k−1] window seeds (+inf/0 where
    the window ran dry, 0.0/0 on masked rows); ``visit``/``visit_d2``:
    int32/f32[N/qt, N/ct] candidate tiles of each query tile by
    increasing box distance; ``counts`` int32[N/qt]: how many of them
    can hold a neighbour.  CUDA tensors launch ``csrc/knn_exact.cu``,
    CPU tensors run :func:`knn_exact_reference`.
    """
    args = (pos, seed_d, seed_i, visit, visit_d2, counts)
    kw = dict(qt=qt, ct=ct, w_excl=w_excl)
    if seed_d.is_cuda:
        return kernels.knn_exact_cuda(*args, **kw)
    return knn_exact_reference(*args, **kw)


def _tile_bbox(pos: torch.Tensor, mask: torch.Tensor, t: int):
    """Per-tile (min, max) f32[N/t, 3] over valid rows (±3e37 if none)."""
    pt = pos.reshape(-1, t, 3)
    mt = mask.reshape(-1, t, 1)
    return (torch.where(mt, pt, 3e37).amin(1),
            torch.where(mt, pt, -3e37).amax(1))


def _prepare(positions, mask, k):
    """Centered columns, window seeds and the per-query-tile visit
    lists (see the module docstring)."""
    n = positions.shape[0]
    query_tile, cand_tile = QUERY_TILE, CAND_TILE
    while query_tile > 8 and n % query_tile:
        query_tile //= 2
    while cand_tile > 8 and n % cand_tile:
        cand_tile //= 2
    if n % query_tile or n % cand_tile:
        raise ValueError(f"N={n} must be a multiple of query_tile="
                         f"{query_tile} and cand_tile={cand_tile}")
    dev = positions.device
    num_q = n // query_tile
    pos = positions.float() - masked_center(positions, mask)
    pos = torch.where(mask[:, None], pos, _SENTINEL)

    # exact visit counts from a provable upper bound on each query's
    # k-th distance: a window's k-th is the k-th over a subset
    w_excl = max(SEED_WINDOW, k)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    wk_i, wk_d = knn_window_sorted(pos, mask, k, window=w_excl)
    kth_ub = torch.where(wk_i[:, k - 1] == rows, torch.inf, wk_d[:, k - 1])
    # the second window over a translated Morton order tightens the
    # bound (its candidates are genuine too); the seeds stay single-order
    # because the kernel's rank exclusion covers only the primary order
    shift = torch.tensor(DUAL_SHIFT, dtype=positions.dtype, device=dev)
    order2 = morton_argsort(positions + shift, mask)
    i2, d2 = knn_window_sorted(pos[order2], mask[order2], k, window=w_excl)
    kth2 = torch.empty_like(kth_ub)
    kth2[order2] = torch.where(i2[:, k - 1] == rows, torch.inf, d2[:, k - 1])
    kth_ub = torch.where(mask, torch.minimum(kth_ub, kth2), 0.0)

    # seeds: window slots 1..k−1; self-padded slots become +inf (rebuilt
    # by the scan); masked rows seed at 0.0 and never bind τ
    pad = wk_i[:, 1:] == rows[:, None]
    seed_d = torch.where(pad, torch.inf, wk_d[:, 1:])
    seed_i = torch.where(pad, 0, wk_i[:, 1:])
    seed_d = torch.where(mask[:, None], seed_d, 0.0).contiguous()
    seed_i = torch.where(mask[:, None], seed_i, 0).to(torch.int32).contiguous()

    # candidate tiles of each query tile by increasing box distance
    qmin, qmax = _tile_bbox(pos, mask, query_tile)
    cmin, cmax = _tile_bbox(pos, mask, cand_tile)
    dd = torch.clamp_min(torch.maximum(cmin[None] - qmax[:, None],
                                       qmin[:, None] - cmax[None]), 0.0)
    boxd2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
             + dd[..., 2] * dd[..., 2])
    visit_d2, visit = torch.sort(boxd2, dim=1, stable=True)
    tau_hat = kth_ub.reshape(num_q, query_tile).amax(1)
    counts = torch.clamp_min((visit_d2 <= tau_hat[:, None]).sum(1), 1)
    cols = tuple(pos[:, d].contiguous() for d in range(3))
    return (cols, seed_d, seed_i, visit.to(torch.int32).contiguous(),
            visit_d2.contiguous(), counts.to(torch.int32), query_tile,
            cand_tile, w_excl)


def _finish(best_d, best_i, mask):
    """Empty slots and masked rows → self at 0; self prepended."""
    n = best_d.shape[0]
    self_i = torch.arange(n, dtype=torch.int32, device=best_d.device)[:, None]
    empty = (best_d >= _SENTINEL_D) | torch.isinf(best_d) | ~mask[:, None]
    nb_i = torch.cat([self_i, torch.where(empty, self_i, best_i)], 1)
    nb_d = torch.cat([torch.zeros((n, 1), dtype=torch.float32,
                                  device=best_d.device),
                      torch.where(empty, 0.0, best_d)], 1)
    return nb_i, nb_d


def knn_pallas(
    positions: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    timings: Optional[dict] = None,
    tiles: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN graph of a (best Morton-sorted) cloud.

    Args:
        positions: int32/float [N, 3]; N a multiple of both tiles after
            halving each (down to 8) until it divides N.
        mask: bool[N].
        k: neighbours INCLUDING self at slot 0.
        timings: receives the spans ``knn.prepare`` (seeds, bound and
            tile lists) and ``knn.exact`` (the #14 launch).
        tiles: receives ``listed``, an int64 scalar on the device: the
            candidate tiles listed over every query tile (Σ ``counts``,
            the most #14 may visit), and ``query_tiles``, an int.

    Returns (indices int32[N, k], squared distances f32[N, k]): slot 0 is
    self, then ascending by (d², index); empty slots are self at 0.
    """
    with annotate("knn.prepare", timings):
        (cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct,
         w_excl) = _prepare(positions, mask, k)
    if tiles is not None:
        tiles["listed"] = counts.sum(dtype=torch.int64)
        tiles["query_tiles"] = counts.shape[0]
    with annotate("knn.exact", timings):
        best_d, best_i = knn_exact(cols, seed_d, seed_i, visit, visit_d2,
                                   counts, qt=qt, ct=ct, w_excl=w_excl)
    return _finish(best_d, best_i, mask)
