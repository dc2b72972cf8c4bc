# Frozen copy of buildingsegment_tpu_torch/ops/compact_sweep.py at commit e8749d5,
# with every hand-written kernel call taken out: each call site runs
# the plain PyTorch version the port holds its kernel to.
"""Compact-space sweep: one whole region-growing iteration per call.

Port of ``compact_sweep`` / ``_compact_kernel`` in
``buildingsegment_tpu/ops/compact_sweep.py``.  Once the live labels of
the window solver fit ``COMPACT_L`` slots, labels are renumbered to slot
ids in ascending label order (min-slot union ≡ min-label union) and
every remaining sweep runs here:

  A-C. per-slot stats [cnt, Σn̂, Σp, Σ|p|²] for all members and for
       anchor-pure members (normal agrees with the slot's seed anchor);
  D.   model refresh (``acc_models`` semantics, pure-count fallback);
  E-F. the ±w hop/merge window pass (``label_sweep`` semantics);
  G.   merge hooks: segment-min of the hook by slot;
  H.   global coplanar-overlap pair tests over all live slot pairs;
  I.   jump rounds (synchronous) on the [lc] parent table;
  J.   apply the parents to the hop result, count changes.

Per-slot sums run in a fixed order shared by both versions: one
partial table per block of 1024 rows (block b covers rows
[b·1024 − w, (b+1)·1024 − w), the TPU kernel's column blocks of its
w-padded slab), each summed in row order, then the tables summed in
block order.  The CUDA kernel (``csrc/compact_sweep.cu``) keeps that
order exactly, and so does the plain version below, through
``segsum.block_order_sums``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.plain import kernels
from benchmark.reference.plain.ops.segsum import block_order_sums
from benchmark.reference.plain.ops.window_sweep import label_sweep_reference

__all__ = ["compact_sweep", "compact_sweep_reference", "compact_slot_stats",
           "compact_pair_parents", "COMPACT_L"]

#: compact slot capacity (the TPU kernel's measured choice, kept so the
#: two packages switch to the compact loop at the same live count)
COMPACT_L = 2048
_CHUNK = 128  # slot chunk of the jump rounds' coverage guard


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def compact_slot_stats(pos, cnrm, clabel, anchor, bound, *, lc, w,
                       th_anchor_cos, anchor_gate, signed=False):
    """Sections A-C of the sweep: f32[lc, 16] per-slot sums [cnt, Σn̂, Σp,
    Σ|p|²] over the members (slot < ``bound``) and the same over the
    anchor-pure members (normal agrees with the slot's anchor; zero
    without ``anchor_gate``).  Block b of ``kernels.COMPACT_STATS_ROWS``
    rows covers rows [b·1024 − w, (b+1)·1024 − w) and adds each slot's
    rows in row order from +0; the block tables are then added in block
    order (the order the CUDA kernel keeps)."""
    n = clabel.shape[0]
    dev = clabel.device
    cmag = (lambda x: x) if signed else torch.abs
    px, py, pz = pos
    cnx, cny, cnz = cnrm
    valid = clabel < bound
    slot = clabel.clamp(max=lc - 1).long()
    sq = px * px + py * py + pz * pz
    base = torch.stack([torch.ones_like(px), cnx, cny, cnz, px, py, pz, sq], 1)
    if anchor_gate:
        anc = anchor[slot]
        agree = cmag(cnx * anc[:, 0] + cny * anc[:, 1] + cnz * anc[:, 2])
        pure = valid & (agree >= th_anchor_cos)
        pure_cols = torch.where(pure[:, None], base, 0.0)
    else:
        pure_cols = torch.zeros_like(base)
    payload = torch.cat([base, pure_cols], 1)
    rows = kernels.COMPACT_STATS_ROWS
    nblk = -(-(n + w) // rows)
    blk = (torch.arange(n, device=dev) + w) // rows
    return block_order_sums(blk[valid], slot[valid], payload[valid], nblk, lc)


def compact_pair_parents(parent, mn, ctr, reach, cnt, bound, *, lc,
                         th_thickness, th_normal_cos, root_gate,
                         signed=False):
    """Section H of the sweep: the global coplanar-overlap tests over the
    live slots below ``bound`` (row i = the partner, column j = the slot
    that hooks; slots with count 0 take no part), and ``parent[:bound]``
    lowered to min(i, j) of each column's passing pairs, i ≠ j.  ``mn``,
    ``ctr``: f32[3, lc] model normals and centers as component rows;
    ``reach``, ``cnt``: f32[lc]; ``parent``: int32[lc].  Returns the new
    parent table."""
    cmag = (lambda x: x) if signed else torch.abs
    b = int(bound)
    mi = [t[:b, None] for t in mn]
    ci = [t[:b, None] for t in ctr]
    mj = [t[None, :b] for t in mn]
    cj = [t[None, :b] for t in ctr]
    ncd = _dot3(mn, ctr)[:b]
    ccd = _dot3(ctr, ctr)
    nrm_sep = _dot3(ci, mj) - ncd[None, :]      # (c_i − c_j)·n_j
    nrm_sep_b = ncd[:, None] - _dot3(mi, cj)    # (c_i − c_j)·n_i
    cosab = cmag(_dot3(mi, mj))
    d2 = ccd[:b, None] + ccd[None, :b] - 2.0 * _dot3(ci, cj)
    inplane2 = torch.clamp_min(d2 - nrm_sep * nrm_sep, 0.0)
    rch = reach[:b, None] + reach[None, :b] + root_gate
    live = cnt[:b] > 0
    ids = torch.arange(b, dtype=torch.int32, device=parent.device)
    ok = (
        (torch.abs(nrm_sep) <= th_thickness)
        & (torch.abs(nrm_sep_b) <= th_thickness)
        & (cosab >= th_normal_cos)
        & (inplane2 <= rch * rch)
        & live[:, None] & live[None, :]
        & (ids[:, None] != ids[None, :])
    )
    pair_lo = torch.where(ok, torch.minimum(ids[:, None], ids[None, :]), lc)
    parent = parent.clone()
    parent[:b] = torch.minimum(parent[:b], pair_lo.amin(dim=0))
    return parent


def compact_sweep_reference(
    pos, nrm, cnrm, mask, clabel, anchor, bound, *, lc, w, th_thickness,
    th_normal_cos, edge_gate2, root_gate, th_anchor_cos, anchor_gate,
    signed=False, jump_rounds=2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`compact_sweep`, section by
    section after the TPU kernel."""
    dev = clabel.device
    valid = clabel < bound
    slot = clabel.clamp(max=lc - 1).long()

    # A-C. per-slot stats, per 1024-row block in row order, then blocks
    acc = compact_slot_stats(pos, cnrm, clabel, anchor, bound, lc=lc, w=w,
                             th_anchor_cos=th_anchor_cos,
                             anchor_gate=anchor_gate, signed=signed)

    # D. models
    cnt = acc[:, 0]
    if anchor_gate:
        usep = acc[:, 8] > 0
        sc = torch.where(usep, acc[:, 8], torch.clamp_min(cnt, 1.0))
        sn = torch.where(usep[:, None], acc[:, 9:12], acc[:, 1:4]) / sc[:, None]
        ctr = torch.where(usep[:, None], acc[:, 12:15], acc[:, 4:7]) / sc[:, None]
        sqm = torch.where(usep, acc[:, 15], acc[:, 7]) / sc
    else:
        sc = torch.clamp_min(cnt, 1.0)
        sn = acc[:, 1:4] / sc[:, None]
        ctr = acc[:, 4:7] / sc[:, None]
        sqm = acc[:, 7] / sc
    sn, ctr = sn.T, ctr.T  # [3, lc] component rows
    ln = torch.sqrt(torch.clamp_min(_dot3(sn, sn), 1e-20))
    mn = sn / ln
    ccd = _dot3(ctr, ctr)
    reach = 2.0 * torch.sqrt(torch.clamp_min(sqm - ccd, 0.0))

    # E-F. per-row models, then the window pass
    def row_model(t):
        return torch.where(valid, t[slot], 0.0)

    new, best = label_sweep_reference(
        pos, nrm, [row_model(t) for t in mn], [row_model(t) for t in ctr],
        clabel, mask, w=w, th_thickness=th_thickness,
        th_normal_cos=th_normal_cos, edge_gate2=edge_gate2, inf_label=lc,
        signed=signed,
    )

    # G. merge hooks: parent[slot] = min(slot, min hook)
    parent = torch.arange(lc, dtype=torch.int32, device=dev)
    hooked = best < lc
    parent.scatter_reduce_(0, slot[hooked], best[hooked], "amin")

    # H. pair tests over live slots
    b = int(bound)
    parent = compact_pair_parents(
        parent, mn, ctr, reach, cnt, b, lc=lc, th_thickness=th_thickness,
        th_normal_cos=th_normal_cos, root_gate=root_gate, signed=signed)

    # I. synchronous jump rounds within the live-chunk cover
    cover = -(-b // _CHUNK) * _CHUNK
    for _ in range(jump_rounds):
        pofp = parent[parent.long()]
        parent = torch.minimum(parent, torch.where(parent < cover, pofp, parent))

    # J. apply + change count + largest surviving slot
    fin = torch.where(new < lc, parent[new.clamp(max=lc - 1).long()], new)
    counters = torch.stack([
        (fin != clabel).sum(),
        torch.where(fin < lc, fin, 0).max(),
    ]).to(torch.int32)
    return fin, counters


def compact_sweep(
    pos, nrm, cnrm, mask, clabel, anchor, bound, *, lc, w, th_thickness,
    th_normal_cos, edge_gate2, root_gate, th_anchor_cos, anchor_gate,
    signed=False, jump_rounds=2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compact-space sweep → (slot labels int32[n], counters
    int32[2] = [rows changed, largest surviving slot id]).

    Args:
        pos, nrm, cnrm: (x, y, z) triples of f32[n] — positions, unit
            normals, canonicalized normals (the stats source).
        mask: bool[n].
        clabel: int32[n] slot labels (``lc`` = none).
        anchor: f32[lc, 3] seed-anchor normal per slot.
        bound: slot-id bound — every live slot id is < bound.

    CUDA tensors launch the CUDA kernels, CPU tensors run
    :func:`compact_sweep_reference`.
    """
    args = (pos, nrm, cnrm, mask, clabel, anchor, bound)
    kw = dict(
        lc=lc, w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        edge_gate2=edge_gate2, root_gate=root_gate,
        th_anchor_cos=th_anchor_cos, anchor_gate=anchor_gate, signed=signed,
        jump_rounds=jump_rounds,
    )
    return compact_sweep_reference(*args, **kw)
