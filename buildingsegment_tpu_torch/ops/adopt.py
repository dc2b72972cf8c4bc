"""Hole adoption of the multigrid finalize against the top-K plane table.

Port of ``plane_adopt`` (kernel ``_adopt_kernel``) in
``buildingsegment_tpu/ops/adopt.py``.  Every unlabeled valid row tests
the K = 128 largest merged planes: plane band |p·n − b| ≤ th, normal
|n̂·n| ≥ cos, and in-plane proximity (|p|² − 2(p·c − |c|²/2)) − off² ≤
reach²; it adopts the first lane of least |off| among the lanes that
pass, and the adopted payload rows are summed per lane.

The TPU kernel packed the plane table into one [8, 384] matrix for a
single MXU product (``pack_adopt_tables``); here the table is plain
component rows (:func:`adopt_table`) and each dot product is written out
(``csrc/adopt.cu``).  The plain version computes the dot products in
the kernel's order and sums the lanes in the kernel's fixed block order
(``kernels.ADOPT_ROWS`` rows per block, row order inside a block, blocks
in order), so the two agree bit for bit.  With ``init`` the block sums
are added onto it (a shard continuing the shards before it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.ops.segsum import block_order_sums

__all__ = ["adopt_table", "plane_adopt", "plane_adopt_reference"]

_K = kernels.ADOPT_LANES


def adopt_table(nk, ck, bk, ccdk, reach2, lane_ok) -> torch.Tensor:
    """The f32[10, 128] lane table: rows n_x n_y n_z b c_x c_y c_z
    |c|²/2 reach² lane_ok (1.0 where the plane may adopt); lanes past
    len(nk) are zero (never ok)."""
    k = nk.shape[0]
    cols = [nk[:, 0], nk[:, 1], nk[:, 2], bk, ck[:, 0], ck[:, 1], ck[:, 2],
            0.5 * ccdk, reach2, lane_ok.float()]
    tab = torch.zeros((10, _K), dtype=torch.float32, device=nk.device)
    tab[:, :k] = torch.stack([c.float() for c in cols], 0)
    return tab


def plane_adopt_reference(
    payload, holes, table, rows, *, th_thickness, th_cos, signed=False,
    init=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`plane_adopt` (the XLA hole fill of
    ``seg/coarse.py``, dots in the kernel's order)."""
    n = holes.shape[0]
    dev = holes.device
    adopted = torch.zeros(n, dtype=torch.bool, device=dev)
    row = torch.zeros(n, dtype=torch.int32, device=dev)
    if init is None:
        acc = torch.zeros((_K, 8), dtype=torch.float32, device=dev)
    else:
        acc = init.float().clone()
    idx = torch.nonzero(holes)[:, 0]
    if idx.numel() == 0:
        return adopted, row, acc
    a = payload[idx]
    ux, uy, uz = (a[:, c:c + 1] for c in (1, 2, 3))
    x, y, z, sq = (a[:, c:c + 1] for c in (4, 5, 6, 7))
    t = [table[r][None, :] for r in range(10)]
    off = x * t[0] + y * t[1] + z * t[2] - t[3]
    aoff = torch.abs(off)
    cos = ux * t[0] + uy * t[1] + uz * t[2]
    if not signed:
        cos = torch.abs(cos)
    pc2 = x * t[4] + y * t[5] + z * t[6] - t[7]
    inpl2 = (sq - 2.0 * pc2) - off * off
    ok = ((aoff <= th_thickness) & (cos >= th_cos) & (inpl2 <= t[8])
          & (t[9] > 0.0))
    offsel = torch.where(ok, aoff, torch.inf)
    m = offsel.min(dim=1, keepdim=True).values
    lanes = torch.arange(_K, device=dev)[None, :]
    lane = torch.where((offsel == m) & ok, lanes, _K).min(dim=1).values
    got = lane < _K
    adopted[idx] = got
    row[idx] = torch.where(got, rows[lane.clamp(max=_K - 1)], 0)
    sel = idx[got]
    nblk = -(-n // kernels.ADOPT_ROWS)
    acc = block_order_sums(sel // kernels.ADOPT_ROWS, lane[got],
                           payload[sel], nblk, _K, init=acc)
    return adopted, row, acc


def plane_adopt(payload, holes, table, rows, *, th_thickness, th_cos,
                signed=False, init=None):
    """Adopt unlabeled rows into the top-K merged plane table.

    Args:
        payload: f32[n, 8] rows [1, n̂x, n̂y, n̂z, px, py, pz, |p|²].
        holes: bool[n] candidate rows (valid and unlabeled).
        table: f32[10, 128] from :func:`adopt_table`.
        rows: int32[128] the merged-root row of each lane.
        init: None, or f32[128, 8] lane sums the adoption sums add onto.

    Returns (adopted bool[n], row int32[n] — the root row each adopted
    row joins, 0 elsewhere — and the per-LANE adoption payload sums
    f32[128, 8]).  CUDA tensors launch the CUDA kernel, CPU tensors run
    :func:`plane_adopt_reference`.
    """
    args = (payload, holes, table, rows)
    kw = dict(th_thickness=th_thickness, th_cos=th_cos, signed=signed,
              init=init)
    if holes.is_cuda:
        return kernels.plane_adopt_cuda(*args, **kw)
    return plane_adopt_reference(*args, **kw)
