"""Stage 1 of the exact-kNN path, worked out from its definition and from
nothing of the port, of the frozen copy (``plain/``) or of kernel #14's
design (no window seed, tiling or box list).

For the shifted points of one scan (integer mm, every coordinate below
2^20):

* each point's list: itself in slot 0, then the ``k`` − 1 other points
  nearest to it, ordered by (squared distance, Morton rank), with their
  squared distances.  The rank is the point's place in
  :func:`benchmark.reference.stage1.morton_order`, the frame the port's
  lists are made in, so ties go by index there.  Distances are exact
  (int64).  The search runs on a uniform grid of ``CELL_MM`` cells: a
  point's candidates are the points of the cube of cells ``ring`` cells
  around its own, and its list is final once its last distance lies
  below the distance from the point to the outside of that cube, which
  bounds every point not in it.  Points not final take a cube one ring
  wider, up to ``LAST_RING``; the rest are searched over every point.
* the hybrid neighbourhood: the list's first ``max_nn`` slots within
  ``radius``; its normal is the eigenvector of its covariance with the
  smallest eigenvalue, from LAPACK's ``eigh`` (numpy), turned to z ≥ 0
  when ``orient_z`` ((0, 0, 1) under three points); the curvature
  λ0 / (λ0 + λ1 + λ2) and ``eigen_gap`` (λ1 − λ0) / (λ0 + λ1 + λ2), 0
  under three points or where the sum is 0.

The moments run in float64, exact for integer millimetres.  As the
control (:func:`benchmark.reference.precision.tf32_products`) they run in
float32 with TF32 products, as :mod:`benchmark.reference.stage1` does;
the lists stay as they are, since the offsets of a list are integers
below 2^11, which TF32 holds exactly, and their squared distances below
2^24, which float32 sums exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import precision
from benchmark.reference.precision import rp
from benchmark.reference.stage1 import morton_order

#: the grid's cell edge (mm), the first ring searched and the last
CELL_MM = 40
FIRST_RING = 3
LAST_RING = 8
#: (query, candidate) pairs a block of the grid search, and query rows a
#: block of the search over every point
PAIRS_A_BLOCK = 1 << 24
ROWS_A_BRUTE_BLOCK = 64
#: rows a block of the moments
ROWS_A_BLOCK = 1 << 16
_NONE = torch.iinfo(torch.int64).max
#: a side of the cube with no cell beyond it bounds nothing
_FAR = 1 << 31


def exact_lists(shifted: np.ndarray, k: int, device, rank: np.ndarray):
    """(indices int64[n, k], squared distances int64[n, k]) of every
    point's list, in input order; slots past the n − 1 other points hold
    the point itself at 0.  ``rank`` int64[n] is each point's Morton
    rank."""
    n = shifted.shape[0]
    dev = torch.device(device)
    self_i = torch.arange(n, dtype=torch.int64, device=dev)
    idx = self_i[:, None].repeat(1, k)
    d2 = torch.zeros((n, k), dtype=torch.int64, device=dev)
    kk = min(k - 1, n - 1)
    if kk <= 0:
        return idx, d2
    pos = torch.from_numpy(shifted.astype(np.int64)).to(dev)
    rank_t = torch.from_numpy(rank.astype(np.int64)).to(dev)
    rank_bits = max(int(n - 1).bit_length(), 1)
    extent = int(pos.max()) + 1
    if (3 * extent * extent).bit_length() + rank_bits > 62:
        raise ValueError("the scan's extent and size overflow the int64 key")
    grid = _Grid(pos, CELL_MM)
    keys = torch.full((n, kk), _NONE, dtype=torch.int64, device=dev)
    todo = torch.ones(n, dtype=torch.bool, device=dev)
    for ring in range(FIRST_RING, LAST_RING + 1):
        cells = torch.unique(grid.cell_of[todo])
        if cells.numel() == 0:
            break
        for block in grid.blocks(cells, ring):
            q, key, final = _search_block(grid, pos, rank_t, rank_bits,
                                          block, ring, kk)
            take = final & todo[q]
            keys[q[take]] = key[take]
            todo[q[take]] = False
    rest = torch.nonzero(todo).flatten()
    for r0 in range(0, rest.numel(), ROWS_A_BRUTE_BLOCK):
        q = rest[r0:r0 + ROWS_A_BRUTE_BLOCK]
        dd = ((pos[q][:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        key = (dd << rank_bits) | rank_t[None, :]
        key[torch.arange(q.numel(), device=dev), q] = _NONE
        keys[q] = torch.topk(key, kk, dim=1, largest=False,
                             sorted=True).values
    by_rank = torch.empty_like(rank_t)
    by_rank[rank_t] = self_i
    idx[:, 1:kk + 1] = by_rank[keys & ((1 << rank_bits) - 1)]
    d2[:, 1:kk + 1] = keys >> rank_bits
    return idx, d2


class _Grid:
    """The points sorted by cell (x, then y, then z), and each occupied
    cell's first row and count in that order."""

    def __init__(self, pos: torch.Tensor, cell: int):
        self.cell = cell
        c = torch.div(pos, cell, rounding_mode="floor")
        self.dims = (c.max(0).values + 1).tolist()
        gy, gz = self.dims[1], self.dims[2]
        cid = (c[:, 0] * gy + c[:, 1]) * gz + c[:, 2]
        self.perm = torch.argsort(cid, stable=True)
        ucell, inv, count = torch.unique_consecutive(
            cid[self.perm], return_inverse=True, return_counts=True)
        self.ucell, self.count = ucell, count
        self.start = torch.cumsum(count, 0) - count
        self.ends = torch.cat([self.start, count.sum().reshape(1)])
        self.cell_of = torch.empty_like(inv)
        self.cell_of[self.perm] = inv
        self.coords = torch.stack([ucell // (gy * gz), ucell // gz % gy,
                                   ucell % gz], 1)

    def ranges(self, cells: torch.Tensor, ring: int):
        """Each cell's candidates as (2·ring + 1)² runs of the sorted rows:
        (first row, length) int64[C, J], one run a column of cells."""
        dev = cells.device
        xyz = self.coords[cells]
        off = torch.arange(-ring, ring + 1, device=dev)
        dx = off.repeat_interleave(off.numel())
        dy = off.repeat(off.numel())
        x = xyz[:, 0:1] + dx[None, :]
        y = xyz[:, 1:2] + dy[None, :]
        gx, gy, gz = self.dims
        inside = (x >= 0) & (x < gx) & (y >= 0) & (y < gy)
        z0 = torch.clamp_min(xyz[:, 2:3] - ring, 0)
        z1 = torch.clamp_max(xyz[:, 2:3] + ring, gz - 1)
        base = (x * gy + y) * gz
        a = torch.searchsorted(self.ucell, base + z0)
        b = torch.searchsorted(self.ucell, base + z1, right=True)
        first = self.ends[a]
        length = torch.where(inside, self.ends[b] - first, 0)
        return first, length

    def blocks(self, cells: torch.Tensor, ring: int):
        """The cells in blocks of at most ``PAIRS_A_BLOCK`` padded pairs
        (or one cell).  The cells go by their number of points, most
        first, then by their candidates, most first, and a block holds
        cells of one number of points, so it pads its candidates to its
        first cell's."""
        first, length = self.ranges(cells, ring)
        total = length.sum(1)
        queries = self.count[cells]
        order = torch.argsort(queries * (total.max() + 1) + total,
                              descending=True, stable=True)
        cells, first, length, total, queries = (
            cells[order], first[order], length[order], total[order],
            queries[order])
        value, runs = torch.unique_consecutive(queries, return_counts=True)
        total = torch.clamp_min(total, 1)
        i = 0
        for most_q, run_end in zip(value.tolist(),
                                   torch.cumsum(runs, 0).tolist()):
            while i < run_end:
                most_c = int(total[i])
                j = min(run_end, i + max(1, PAIRS_A_BLOCK
                                         // (most_q * most_c)))
                yield cells[i:j], first[i:j], length[i:j], most_q, most_c
                i = j


def _search_block(grid, pos, rank_t, rank_bits, block, ring, kk):
    """The block's queries (its cells' points) → (query rows int64[M],
    their kk smallest keys int64[M, kk], whether each list is final)."""
    cells, first, length, most_q, most_c = block
    dev = pos.device
    n = pos.shape[0]
    cum = torch.cumsum(length, 1)
    t = torch.arange(most_c, device=dev)
    j = torch.searchsorted(cum, t.expand(cells.numel(), -1).contiguous(),
                           right=True)
    valid_c = t[None, :] < cum[:, -1:]
    j = torch.clamp_max(j, length.shape[1] - 1)
    row = (torch.gather(first, 1, j) + t[None, :]
           - (torch.gather(cum, 1, j) - torch.gather(length, 1, j)))
    cand = grid.perm[row.clamp(0, n - 1)]
    s = torch.arange(most_q, device=dev)
    valid_q = s[None, :] < grid.count[cells][:, None]
    q = grid.perm[(grid.start[cells][:, None] + s[None, :]).clamp(0, n - 1)]
    dd = torch.zeros(q.shape + cand.shape[1:], dtype=torch.int64, device=dev)
    for a in range(3):
        diff = pos[q, a][:, :, None] - pos[cand, a][:, None, :]
        dd += diff * diff
    key = (dd << rank_bits) | rank_t[cand][:, None, :]
    bad = ~valid_c[:, None, :] | (cand[:, None, :] == q[:, :, None])
    key = torch.where(bad, _NONE, key)
    short = kk - key.shape[-1]
    if short > 0:
        key = torch.cat([key, key.new_full((*key.shape[:-1], short), _NONE)],
                        -1)
    key = torch.topk(key, kk, dim=-1, largest=False, sorted=True).values
    # the distance from each query to the outside of its cube: every
    # point beyond a face lies at least that far (coordinates are integer)
    xyz = grid.coords[cells][:, None, :]
    p = pos[q]
    lo_cell = xyz - ring
    hi_cell = xyz + ring + 1
    dims = torch.tensor(grid.dims, device=dev)
    below = torch.where(lo_cell > 0, p - lo_cell * grid.cell + 1, _FAR)
    above = torch.where(hi_cell < dims, hi_cell * grid.cell - p, _FAR)
    bound = torch.minimum(below, above).amin(-1)
    whole = bound >= _FAR
    last = key[..., -1]
    final = whole | ((last != _NONE)
                     & ((last >> rank_bits) < bound * bound))
    return q[valid_q], key[valid_q], final[valid_q]


def exact_stage1(shifted: np.ndarray, *, k: int, radius: float, max_nn,
                 orient_z: bool, device) -> dict:
    """Stage 1 of one scan, in input order: ``neigh_idx`` int32[n, k],
    ``neigh_sq_dist`` float64[n, k], ``normals`` [n, 3], ``curvature``
    [n], ``eigen_gap`` [n] (float64; the moments float32 as the
    control)."""
    n = shifted.shape[0]
    if shifted.size and not (0 <= int(shifted.min())
                             and int(shifted.max()) < 1 << 20):
        raise ValueError("stage 1 takes shifted coordinates in [0, 2^20)")
    order = morton_order(shifted)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    dev = torch.device(device)
    idx, d2 = exact_lists(shifted, k, dev, rank)
    if not n:
        return {"neigh_idx": np.zeros((0, k), np.int32),
                "neigh_sq_dist": np.zeros((0, k)),
                "normals": np.zeros((0, 3)), "curvature": np.zeros(0),
                "eigen_gap": np.zeros(0)}
    dt = torch.float32 if precision.active() else torch.float64
    pos = torch.from_numpy(shifted).to(dev).to(dt)
    cap = k if max_nn is None else min(max_nn, k)
    r2 = float(radius) * float(radius)
    s0s, covs = [], []
    for r0 in range(0, n, ROWS_A_BLOCK):
        rows = slice(r0, min(n, r0 + ROWS_A_BLOCK))
        nb = idx[rows, :cap]
        u = (d2[rows, :cap] <= r2).to(dt)
        off = rp(pos[nb] - pos[rows][:, None, :])
        s0 = u.sum(1)
        s1 = (u[..., None] * off).sum(1)
        s2 = torch.einsum("rj,rja,rjb->rab", u, off, off)
        mean = rp(s1 / s0[:, None])
        cov = s2 / s0[:, None, None] - mean[:, :, None] * mean[:, None, :]
        s0s.append(s0)
        covs.append(cov)
    # the eigen solve on the host (LAPACK), in the type of the moments
    evals, evecs = np.linalg.eigh(torch.cat(covs).cpu().numpy())
    few = torch.cat(s0s).cpu().numpy() < 3.0
    v = np.where(few[:, None], np.array([0.0, 0.0, 1.0], evecs.dtype),
                 evecs[:, :, 0])
    if orient_z:
        v = np.where((v[:, 2] < 0.0)[:, None], -v, v)
    total = evals.sum(1)
    safe = np.where(total > 0, total, 1.0)
    curv = np.where(few | (total <= 0), 0.0, evals[:, 0] / safe)
    gap = np.where(few | (total <= 0), 0.0, (evals[:, 1] - evals[:, 0]) / safe)
    return {"neigh_idx": idx.to(torch.int32).cpu().numpy(),
            "neigh_sq_dist": d2.to(torch.float64).cpu().numpy(),
            "normals": v, "curvature": curv.astype(evals.dtype),
            "eigen_gap": gap}
