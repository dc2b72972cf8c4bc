"""Planar region growing — parallel fixed-point label propagation.

Port of ``segment_planes`` from ``buildingsegment_tpu/seg/region_grow.py``
(single device).  The reference's sequential recursive region growing
(``seg_plane::{get_planes, Broad}``, tmc3/my_function.cpp:180-258) as a
data-parallel fixed point:

1. seed gating — the depth-0 rule over the kNN graph: a point is a seed
   iff all K−1 neighbors pass its tangent-plane test;
2. model-anchored label propagation, in one of two forms:

   * ``propagation="window"`` (a Morton-sorted cloud): ±window slices of
     the sorted order (``label_sweep``), with window and global coplanar
     merges collapsed by jump rounds; once the live labels fit
     ``COMPACT_L`` slots, the remaining sweeps run in compact slot space
     (``compact_sweep``);
   * ``propagation="graph"`` (any order; the exact-kNN paths): per sweep
     the label models, four hops along the kNN edges (reverse edges
     adopt, forward edges push — the reference's growth direction,
     my_function.cpp:224-236), a union of adjacent regions whose seed
     models accept each other (``ops/graph_hop``: one edge walk for
     both, a kernel on the card), and the global coplanar merge over
     min(max_planes, N) slots, each merge collapsed by 12 jump rounds;
3. size culling (strict >, my_function.cpp:199) and dense renumbering
   in ascending seed order (my_function.cpp:200-201), plus the plane
   table.

The window is ±16 sorted rows (the JAX package's default, which its
pipeline uses).  JAX's ``lax.while_loop`` becomes a Python loop that reads the sweep's
change count (and the counters the loop conditions need) once per sweep:
one host sync per sweep, counted in ``SegmentationResult.host_syncs``.

The multigrid solver (``seg/coarse.py``) derives its seeds with
:func:`window_seeds` (the same rule over ±window rows, on the seed-sweep
kernel) and hands each level its seeds through ``seed_override``.

Sharded (``group``, a ``dist.ShardGroup``; the JAX package's
``axis_name``): each rank holds a contiguous range of the sorted rows,
labels are global row ids (``ng = n · world``, rank r's rows from
``r · n``), the window sweeps read ring halos, the f32 label tables are
summed over the ranks in rank order (``group.fold``: the one-device
sums), the merge parents are min-reduced, the change count summed.
Every value a loop test reads on the host has been reduced first, so
all ranks take the same path.  The compact loop has no sharded form
and runs at world 1 only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from buildingsegment_tpu_torch.ops.compact_sweep import COMPACT_L, compact_sweep
from buildingsegment_tpu_torch.ops.graph_hop import (
    graph_edges,
    graph_hop,
    graph_points,
    graph_union_hooks,
    model_table,
)
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.prefix import prefix_sum_i32
from buildingsegment_tpu_torch.ops.segsum import segment_sums
from buildingsegment_tpu_torch.ops.stats_mxu import mxu_halo, seed_sweep_mxu
from buildingsegment_tpu_torch.ops.window_sweep import (
    halo_columns,
    label_sweep,
    seed_sweep,
)
from buildingsegment_tpu_torch.profiling import annotate

__all__ = ["segment_planes", "SegmentationResult", "window_seeds",
           "SEED_MODES"]

#: ``seg_seed_mode`` values: None, "pair" and "sym" are the exact seed
#: sweep (the JAX package's two kernels give the same bits), "mxu" the
#: block-form variant
SEED_MODES = (None, "pair", "sym", "mxu")

#: jump-doubling rounds per sweep (the JAX package's default)
JUMP_ROUNDS = 2
#: graph propagation: one-hop rounds per sweep, and jump rounds per merge
GRAPH_HOPS = 4
GRAPH_JUMP_ROUNDS = 12
#: half-width of the propagation window in sorted rows
WINDOW = 16
#: largest problem the compact loop takes (the TPU kernel's VMEM bound,
#: kept so both packages take the same path)
COMPACT_MAX_ROWS = 262144


@dataclasses.dataclass(frozen=True)
class SegmentationResult:
    """Output of :func:`segment_planes`.

    Attributes:
        plane_idx: int32[N] — plane id per point, 1..num_planes, or −1.
        num_planes: number of accepted planes P.
        plane_normal: float32[max_planes, 3] — mean unit normal (row p−1
            for plane id p); zero rows beyond P.
        plane_center: float32[max_planes, 3] — mean position per plane.
        plane_count: int32[max_planes] — member count per plane.
        num_sweeps: propagation sweeps run.
        diagnostics: int32[4] — [peak live labels, peak live labels
            beyond the per-sweep merge cap, planes beyond max_planes,
            1 if the solve stopped at max_sweeps unconverged].
        host_syncs: device→host reads the solve made.
        timings: host seconds by span (``seg.seed``, ``seg.sweep``,
            ``seg.sync`` — one a read counted in ``host_syncs`` —,
            ``seg.finish``; the multigrid levels add ``mg.*``), summed
            over spans of one name.  No span synchronizes.
        finalize_counts: int32[5] on the solve's device, the multigrid
            solve's outermost finalize (:data:`coarse.FINALIZE_COUNTERS`:
            holes, holes adopted, live roots culled, flat live roots
            outside the adoption lanes, rows labeled −1); None on the
            other solves and on a sharded solve.
        finalize_rows: L, the side of that finalize's pair test, where
            ``finalize_counts`` is given; else 0.
    """

    plane_idx: torch.Tensor
    num_planes: int
    plane_normal: torch.Tensor
    plane_center: torch.Tensor
    plane_count: torch.Tensor
    num_sweeps: int
    diagnostics: torch.Tensor
    host_syncs: int = 0
    timings: dict = dataclasses.field(default_factory=dict)
    finalize_counts: Optional[torch.Tensor] = None
    finalize_rows: int = 0


def _sum3(t: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, in the order (t0 + t1) + t2."""
    return t[..., 0] + t[..., 1] + t[..., 2]


def _outer_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, B] table of a_i · b_j for a [A, 3], b [B, 3]."""
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]
            + a[:, None, 2] * b[None, :, 2])


def _acc_models(rows: torch.Tensor):
    """(unit normal, center, rms radius, cnt_all) from stats rows.

    Columns 0-7 are all-member sums [cnt, Σn̂, Σp, Σ|p|²]; 16-col rows
    add the anchor-pure sums in the same layout.  Models come from the
    pure sums, falling back to the all-member sums for labels whose pure
    count is zero; 8-col rows use the all-member sums directly.
    """
    cnt_a = rows[..., 0]
    if rows.shape[-1] == 8:
        sc = torch.clamp_min(cnt_a, 1.0)[..., None]
        sn = rows[..., 1:4] / sc
        c = rows[..., 4:7] / sc
        sq = rows[..., 7] / sc[..., 0]
    else:
        cnt_p = rows[..., 8]
        usep = cnt_p > 0
        sc = torch.where(usep, cnt_p, torch.clamp_min(cnt_a, 1.0))[..., None]
        sn = torch.where(usep[..., None], rows[..., 9:12], rows[..., 1:4]) / sc
        c = torch.where(usep[..., None], rows[..., 12:15], rows[..., 4:7]) / sc
        sq = torch.where(usep, rows[..., 15], rows[..., 7]) / sc[..., 0]
    ln = torch.sqrt(torch.clamp_min(_sum3(sn * sn), 1e-20))[..., None]
    r = torch.sqrt(torch.clamp_min(sq - _sum3(c * c), 0.0))
    return sn / ln, c, r, cnt_a


def _shard_kw(group) -> dict:
    """The ``group`` keyword of a sharded sweep call; one-device calls
    pass none (they keep the wrappers' one-device signature)."""
    return {} if group is None else {"group": group}


def window_seeds(
    positions: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    kth_sq_dist: torch.Tensor,
    *,
    window: int = WINDOW,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    signed_normals: bool = False,
    seed_mode=None,
    group=None,
) -> torch.Tensor:
    """Strict depth-0 seed rule over ±window sorted rows → bool[N].

    The reference's rule ("every one of the k−1 nearest neighbors
    passes the plane test", tmc3/my_function.cpp:238) on a Morton-sorted
    cloud: row i is a seed iff no window candidate within its k-th-NN
    radius (``kth_sq_dist``, squared) fails the test.  ``seed_mode`` is
    one of :data:`SEED_MODES`; "mxu" runs the block-form variant (the
    config's ``seg_seed_mode``).  With ``group`` the inputs are this
    rank's rows and the window reads the neighbours' rows (a ring halo).
    """
    if seed_mode not in SEED_MODES:
        raise ValueError(f"seed_mode={seed_mode!r}, expected one of "
                         f"{SEED_MODES}")
    sweep = seed_sweep_mxu if seed_mode == "mxu" else seed_sweep
    pos = tuple(positions[:, d].float().contiguous() for d in range(3))
    nrm = tuple(normals[:, d].float().contiguous() for d in range(3))
    dk = kth_sq_dist.float().contiguous()
    if group is not None:
        h = mxu_halo(window) if seed_mode == "mxu" else window
        pos, nrm, mask = halo_columns(group, h, pos, nrm, mask)
        # a candidate's ball is never read: the halo rows keep zeros
        zeros = dk.new_zeros(h)
        dk = torch.cat([zeros, dk, zeros])
    return sweep(
        pos, nrm, mask, dk, w=window,
        th_thickness=float(th_thickness), th_normal_cos=float(th_normal_cos),
        signed=signed_normals, **_shard_kw(group),
    )


def segment_planes(
    positions: torch.Tensor,
    normals: torch.Tensor,
    neigh_idx: Optional[torch.Tensor],
    mask: torch.Tensor,
    *,
    neigh_sq_dist: Optional[torch.Tensor] = None,
    max_edge_dist: Optional[float] = None,
    seed_override: Optional[torch.Tensor] = None,
    curvature: Optional[torch.Tensor] = None,
    th_seed_curvature: Optional[float] = None,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    th_point_count: int = 400,
    max_planes: int = 4096,
    max_sweeps: int = 64,
    convergence_tol: float = 0.0,
    signed_normals: bool = False,
    propagation: str = "window",
    th_anchor_cos: float = 0.95,
    compact: Optional[bool] = None,
    group=None,
) -> SegmentationResult:
    """Segment a point cloud into planar regions.

    Args:
        positions: int32/float [N, 3] bbox-shifted (Morton-sorted for
            ``propagation="window"``).
        normals: float32[N, 3] unit normals.
        neigh_idx: int32[N, K] kNN graph (self at slot 0) — feeds the
            seed rule and the graph propagation; None with
            ``seed_override`` and window propagation.
        mask: bool[N] validity.
        neigh_sq_dist: float32[N, K] squared neighbor distances; with
            ``max_edge_dist`` they gate the seed graph's edges.
        seed_override: bool[N] caller-supplied seeds in place of the
            graph rule (the multigrid levels); ANDed with ``mask``.
        propagation: "window" or "graph" (see the module docstring).
            Unlike the JAX package, whose default is "graph", the
            default is "window": the window and multigrid paths call
            this without naming it.
        th_anchor_cos: anchor-pure model estimation — a member feeds its
            region's mean model only when its normal agrees with the
            region seed's normal by this cosine (≤ th_normal_cos
            disables the gate).
        compact: force the compact loop on (True) or off (False).  None
            takes it on the card when 2048 < N ≤ 262,144 — where the JAX
            package takes it on the TPU — and never on the CPU, where
            the JAX package keeps its XLA loop.  The graph propagation
            never takes it, nor a sharded solve above world 1.
        group: a ``dist.ShardGroup`` (module docstring): the inputs are
            this rank's rows of the sorted cloud; needs
            ``propagation="window"`` and ``seed_override``.  ``plane_idx``
            holds this rank's rows, the tables are the same on every rank.
    """
    if propagation not in ("window", "graph"):
        raise ValueError(f"propagation={propagation!r}")
    if group is not None and (propagation != "window"
                              or seed_override is None):
        raise ValueError("sharded segment_planes needs propagation='window' "
                         "and seed_override (see window_seeds)")
    dev = positions.device
    n = positions.shape[0]
    pos = positions.float()
    nrm = normals.float()
    world = 1 if group is None else group.world
    ng = n * world  # the global label space
    base = 0 if group is None else group.rank * n
    inf = ng
    syncs = 0
    timings = {}

    def read(t):
        """``t.tolist()``: a device → host read of the solve, counted in
        ``host_syncs`` and timed as a ``seg.sync`` span."""
        nonlocal syncs
        syncs += 1
        with annotate("seg.sync", timings):
            return t.tolist()

    with annotate("seg.seed", timings):
        cmag = (lambda x: x) if signed_normals else torch.abs
        sns = nrm if signed_normals else canonicalize_normals(nrm)
        rows_ng = torch.arange(ng, dtype=torch.int32, device=dev)
        gid = rows_ng[base:base + n]  # this rank's rows' global ids

        def fold_sums(idx, rows, size):
            """segment_sums over every rank's rows, in global row order (rows
            with an id at or above ``size`` add nothing)."""
            if group is None:
                return segment_sums(idx, rows, size)
            return group.fold(lambda init: segment_sums(idx, rows, size, init),
                              (size, rows.shape[1]))

        # the kNN-graph edges i → neigh[i, 1:], gated by validity and (with
        # distances and a gate) by length
        graph = propagation == "graph"
        if graph or seed_override is None:
            nb, nb_valid = graph_edges(neigh_idx, mask, neigh_sq_dist,
                                       max_edge_dist)
        if graph:
            points = graph_points(pos, nrm)
            walk_kw = dict(th_thickness=float(th_thickness),
                           th_normal_cos=float(th_normal_cos),
                           signed=signed_normals)

        # 1. seed gating over the kNN graph (depth-0 rule), or the caller's
        if seed_override is not None:
            seed = seed_override & mask
        else:
            nbl = nb.long()
            dist = torch.abs(
                _sum3((pos[nbl] - pos[:, None, :]) * nrm[:, None, :]))
            cos = cmag(_sum3(nrm[nbl] * nrm[:, None, :]))
            fwd_ok = (dist <= th_thickness) & (cos >= th_normal_cos) & nb_valid
            seed = fwd_ok.all(dim=1) & mask
            del nbl, dist, cos, fwd_ok
        if curvature is not None and th_seed_curvature is not None:
            seed = seed & (curvature <= th_seed_curvature)

        # anchor table: row r holds the seed normal of label r for the whole
        # solve (purity gate of the model sums)
        anchor_gate = th_anchor_cos > th_normal_cos
        anchor_tab = (torch.where(seed[:, None], sns, 0.0) if anchor_gate
                      else None)
        if anchor_gate and group is not None:
            anchor_tab = group.all_gather(anchor_tab)  # [ng, 3]

        def purity(label):
            if not anchor_gate:
                return label < inf
            anc = anchor_tab[label.clamp(0, ng - 1)]
            agree = cmag(_sum3(sns * anc))
            return (label < inf) & (agree >= th_anchor_cos)

        ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
        payload8_sq = torch.cat([ones, sns, pos, _sum3(pos * pos)[:, None]], 1)
        payload8 = torch.cat([ones, sns, pos, torch.zeros_like(ones)], 1)

        def stats_payload(label, valid, with_sq):
            """Per-point payload: 8 all-member columns [cnt, Σn̂, Σp,
            Σ|p|²], plus 8 anchor-pure columns when the anchor gate is
            on."""
            base = payload8_sq if with_sq else payload8
            if anchor_gate:
                wp = purity(label).float()[:, None]
                payload = torch.cat([base, base * wp], 1)
            else:
                payload = base
            return torch.where(valid[:, None], payload, 0.0)

        label0 = torch.where(seed, gid, inf)
        ws = WINDOW
        # contiguous component columns, made once: the kernels take [n] rows
        px, py, pz = (pos[:, d].contiguous() for d in range(3))
        nx_, ny_, nz_ = (nrm[:, d].contiguous() for d in range(3))
        if group is not None:
            # the sweep's fixed columns with their ring halos, once a solve
            halo_pos, halo_nrm, halo_mask = halo_columns(
                group, ws, (px, py, pz), (nx_, ny_, nz_), mask)
        edge_gate_val = (
            max_edge_dist if max_edge_dist is not None else 2 * th_thickness
        )
        root_gate = float(np.sqrt(np.float32(edge_gate_val ** 2)))
        # per-sweep global-merge table capacity (labels beyond it defer
        # their global merge to a later sweep)
        L = min(max_planes, ng, 1024)
        sweep_kw = dict(
            w=ws, th_thickness=float(th_thickness),
            th_normal_cos=float(th_normal_cos), edge_gate2=edge_gate_val ** 2,
            signed=signed_normals,
        )

    def compact_slots(flag, cap):
        """Live labels (``flag``) → the first ``cap`` slots by rank:
        (inclusive rank, slot → label, slot is live)."""
        rank = prefix_sum_i32(flag.to(torch.int32))
        slot_of = torch.where(flag & (rank <= cap), rank - 1, cap).long()
        top_lab = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
        top_lab[slot_of] = rows_ng
        top_lab = top_lab[:cap]
        return rank, torch.clamp_min(top_lab, 0), top_lab >= 0

    def pair_row_min(rows, top_lab, live):
        """Global coplanar-overlap hooks on a compact table of stats rows:
        per slot, the smallest partner label whose model is mutually in
        band, parallel and overlapping in-plane (inf if none)."""
        n_tab, c_tab, r_tab, _cnt = _acc_models(rows)
        nc = _sum3(n_tab * c_tab)
        ncT = _outer_dot(n_tab, c_tab)
        nrm_sep = ncT - nc[:, None]
        nrm_sep_b = nc[None, :] - ncT.T
        cosab = cmag(_outer_dot(n_tab, n_tab))
        ccd = _sum3(c_tab * c_tab)
        d2 = ccd[:, None] + ccd[None, :] - 2.0 * _outer_dot(c_tab, c_tab)
        inplane2 = torch.clamp_min(d2 - nrm_sep * nrm_sep, 0.0)
        reach = 2.0 * (r_tab[:, None] + r_tab[None, :]) + root_gate
        ok_pair = (
            (torch.abs(nrm_sep) <= th_thickness)
            & (torch.abs(nrm_sep_b) <= th_thickness)
            & (cosab >= th_normal_cos)
            & (inplane2 <= reach * reach)
            & live[:, None] & live[None, :]
        )
        la, lb = top_lab[:, None], top_lab[None, :]
        pair_lo = torch.where(ok_pair & (la != lb), torch.minimum(la, lb), inf)
        return pair_lo.amin(dim=1)

    def jumps(parent, rounds):
        for _ in range(rounds):
            parent = torch.minimum(parent, parent[parent.clamp(0, ng - 1).long()])
        return parent

    def collapse(idx, val, rounds):
        """Parent table: each label hooked to the min of the ``val`` aimed
        at it (index ``ng`` = no hook; the min over the ranks when
        sharded), then ``rounds`` jump rounds."""
        parent = torch.cat([rows_ng, rows_ng.new_full((1,), inf)])
        parent.scatter_reduce_(0, idx.reshape(-1).long(), val.reshape(-1),
                               "amin")
        parent = parent[:ng]
        if group is not None:
            parent = group.pmin(parent)
        return jumps(parent, rounds)

    def relabel(parent, label):
        return torch.where(label < inf, parent[label.clamp(0, ng - 1).long()],
                           label)

    def window_body(label, singleton=False):
        """One iteration: stats → compact [L] table → window sweep →
        window + global merge hooks → jump rounds → apply.

        ``singleton=True`` specializes the first sweep, where every label
        is its own row or none: the stats row of label g IS row g's
        payload and its model IS the row's own normal/position
        (bit-identical values, no scatter or gather).
        """
        valid = label < inf
        if singleton:
            if anchor_gate:
                agree = cmag(_sum3(sns * sns))
                pure_v = valid & (agree >= th_anchor_cos)
                payload = torch.cat(
                    [torch.where(valid[:, None], payload8_sq, 0.0),
                     torch.where(pure_v[:, None], payload8_sq, 0.0)], 1)
            else:
                payload = torch.where(valid[:, None], payload8_sq, 0.0)
            flag = valid
            ln = torch.sqrt(torch.clamp_min(_sum3(sns * sns), 1e-20))[:, None]
            mp = torch.where(valid[:, None], torch.cat([sns / ln, pos], 1), 0.0)
            acc = None
        else:
            tgt = torch.where(valid, label, ng).long()  # ng: dropped
            payload = stats_payload(label, valid, with_sq=True)
            acc = fold_sums(tgt, payload, ng)
            model_n, model_c, _r, cnt = _acc_models(acc)
            flag = cnt > 0

        # live labels → [L] slots by rank
        rank, top_lab, live = compact_slots(flag, L)

        # window sweep: hop-min + merge-hook candidates
        sw_pos, sw_nrm, sw_mask, sw_label = ((px, py, pz), (nx_, ny_, nz_),
                                             mask, label)
        if group is not None:
            # only the labels take new halos: the halo rows' models come
            # from the same (replicated) table
            sw_pos, sw_nrm, sw_mask = halo_pos, halo_nrm, halo_mask
            sw_label = group.halo_pad(label, ws, fill=inf)
            if singleton:
                mp = group.halo_pad(mp, ws, fill=0.0)
        if not singleton:
            model_nc = torch.cat([model_n, model_c], 1)
            mp = torch.where((sw_label < inf)[:, None],
                             model_nc[sw_label.clamp(0, ng - 1)], 0.0)
        new, best = label_sweep(
            sw_pos, sw_nrm,
            (mp[:, 0], mp[:, 1], mp[:, 2]), (mp[:, 3], mp[:, 4], mp[:, 5]),
            sw_label, sw_mask, inf_label=inf, **_shard_kw(group),
            **sweep_kw,
        )

        # global coplanar-overlap pairs on the compact [L] table
        row_min = pair_row_min(payload[top_lab] if singleton else acc[top_lab],
                               top_lab, live)

        # one scatter-min hooks both merge kinds
        idx_cat = torch.cat([
            torch.where(best < inf, label, ng),
            torch.where(row_min < inf, top_lab, ng),
        ])
        parent = collapse(idx_cat, torch.cat([best, row_min]), JUMP_ROUNDS)
        live_cnt = rank[ng - 1]
        return relabel(parent, new), live_cnt, torch.clamp_min(live_cnt - L, 0)

    def changes(new, label):
        """Rows whose label changed, over every rank."""
        nch = (new != label).sum()
        return nch if group is None else group.psum(nch)

    # graph propagation (the JAX package's graph branch of ``body``)
    def label_models(label):
        """Per-label mean models by segment sums, indexed by label value:
        the f32[ng, 8] table of ``ops.graph_hop.model_table``."""
        valid = label < inf
        tgt = torch.where(valid, label, ng).long()  # ng: dropped
        acc = segment_sums(tgt, stats_payload(label, valid, with_sq=False),
                           ng)
        model_n, model_c, _r, _cnt = _acc_models(acc)
        return model_table(model_n, model_c)

    def merge_labels(label, models):
        """Union adjacent regions whose seed models accept each other."""
        parent = graph_union_hooks(label, nb, nb_valid, models, **walk_kw)
        return relabel(jumps(parent, GRAPH_JUMP_ROUNDS), label)

    def global_merge(label, live_bound):
        """Coplanar overlapping regions unioned over min(max_planes, N)
        slots, graph-free.  Live labels take the lowest slots, so the
        pair test runs on the first ``live_bound`` (a bound on the live
        count) only — the other slots hold no live label, so the hooks
        are the same as over all of them."""
        cap = min(max_planes, ng)
        valid = label < inf
        tgt = torch.where(valid, label, ng).long()  # ng: dropped
        acc = segment_sums(tgt, stats_payload(label, valid, with_sq=True),
                           ng)
        rank, top_lab, live = compact_slots(acc[:, 0] > 0, cap)
        used = max(min(cap, live_bound), 1)
        top_lab, live = top_lab[:used], live[:used]
        row_min = pair_row_min(acc[top_lab], top_lab, live)
        hooked = row_min < inf
        parent = collapse(torch.where(hooked, top_lab, ng),
                          torch.where(hooked, row_min, inf), GRAPH_JUMP_ROUNDS)
        live_cnt = rank[ng - 1]
        return (relabel(parent, label), live_cnt,
                torch.clamp_min(live_cnt - cap, 0))

    def graph_body(label, live_bound):
        models = label_models(label)
        new = label
        for _ in range(GRAPH_HOPS):
            new = graph_hop(new, nb, nb_valid, points, models, **walk_kw)
        return global_merge(merge_labels(new, models), live_bound)

    def live_count(label):
        flags = torch.zeros(ng + 1, dtype=torch.bool, device=dev)
        flags[label.clamp(max=inf).long()] = True
        return flags[:ng]

    tol_count = max(1, int(convergence_tol * ng))
    if graph or world > 1:
        use_compact = False
    elif compact is None:
        use_compact = positions.is_cuda and COMPACT_L < ng <= COMPACT_MAX_ROWS
    else:
        use_compact = bool(compact) and ng <= COMPACT_MAX_ROWS

    if not use_compact:
        label, changed, it, peak_live, peak_over = label0, True, 0, 0, 0
        if graph:
            # Invariant: a sweep only copies existing label values (hops,
            # unions and merges pick among labels already present), so
            # the live count never grows.  The seed count bounds the
            # first global merge's live count, and each merge's count
            # (read below) bounds the next one's; global_merge runs its
            # [L, L] pair test on that many slots only.
            live_bound = read(seed.sum())
        while changed and it < max_sweeps:
            with annotate("seg.sweep", timings):
                if graph:
                    new, live, over = graph_body(label, live_bound)
                else:
                    new, live, over = window_body(label)
                counts = torch.stack([changes(new, label), live, over])
            nch, live, over = read(counts)
            if graph:
                live_bound = live
            label, changed, it = new, nch >= tol_count, it + 1
            peak_live, peak_over = max(peak_live, live), max(peak_over, over)
        unconverged, sweeps_used = changed, it
    else:
        lc = COMPACT_L
        if max_sweeps >= 1:
            # sweep 1 with the singleton specialization
            with annotate("seg.sweep", timings):
                label, live, over = window_body(label0, singleton=True)
                counts = torch.stack([(label != label0).sum(), live, over,
                                      live_count(label).sum()])
            nch, live, over, live_now = read(counts)
            changed, it, peak_live, peak_over = nch >= tol_count, 1, live, over
        else:
            label, changed, it, peak_live, peak_over = label0, True, 0, 0, 0
            live_now = read((label0 < inf).sum())
        while changed and it < max_sweeps and live_now > lc:
            with annotate("seg.sweep", timings):
                new, live, over = window_body(label)
                counts = torch.stack([(new != label).sum(), live, over,
                                      live_count(new).sum()])
            nch, live, over, live_now = read(counts)
            label, changed, it = new, nch >= tol_count, it + 1
            peak_live, peak_over = max(peak_live, live), max(peak_over, over)

        # relabel to compact slots (rank order ⇒ slot order ≡ label order)
        flags = live_count(label)
        crank = prefix_sum_i32(flags.to(torch.int32))
        live0 = read(crank[ng - 1])
        peak_live = max(peak_live, live0)
        if live0 <= lc and changed and it < max_sweeps:
            slot_of = torch.where(flags & (crank <= lc), crank - 1, lc)
            top_lab = torch.full((lc + 1,), -1, dtype=torch.int32, device=dev)
            top_lab[slot_of.long()] = rows_ng
            top_lab = top_lab[:lc]
            clab = torch.where(
                label < inf, slot_of[label.clamp(0, ng - 1).long()], lc
            ).to(torch.int32)
            if anchor_gate:
                anc_c = torch.where(
                    (top_lab >= 0)[:, None],
                    anchor_tab[top_lab.clamp(0, ng - 1).long()], 0.0,
                )
            else:
                anc_c = torch.zeros((lc, 3), dtype=torch.float32, device=dev)
            sns_cols = tuple(sns[:, d].contiguous() for d in range(3))
            bound = max(live0, 1)
            while changed and it < max_sweeps:
                with annotate("seg.sweep", timings):
                    clab, counters = compact_sweep(
                        (px, py, pz), (nx_, ny_, nz_), sns_cols, mask, clab,
                        anc_c, bound, lc=lc, root_gate=root_gate,
                        th_anchor_cos=float(th_anchor_cos),
                        anchor_gate=anchor_gate, jump_rounds=JUMP_ROUNDS,
                        **sweep_kw,
                    )
                nchg, top = read(counters)
                changed, it = nchg >= tol_count, it + 1
                # min-slot merging skews survivors low: tighten the
                # slot-id bound to the largest surviving slot + 1
                bound = min(max(top + 1, 1), bound)
            label = torch.where(
                clab < lc, top_lab[clab.clamp(0, lc - 1).long()], inf
            )
        unconverged, sweeps_used = changed, it
    with annotate("seg.finish", timings):
        label = torch.where(mask, label, inf)

        # 5. cull small planes (strict >)
        counts = torch.bincount(label.clamp(max=ng).long(), minlength=ng + 1)
        if group is not None:
            counts = group.psum(counts)
        surviving = counts[:ng] > th_point_count
        keep = (label < inf) & surviving[label.clamp(0, ng - 1).long()]
        label = torch.where(keep, label, inf)

        # 6. dense renumber in ascending seed order → ids 1..P
        rank = prefix_sum_i32(surviving.to(torch.int32))
        plane_id = torch.where(
            label < inf, rank[label.clamp(0, ng - 1).long()], 0
        ).to(torch.int32)
        plane_idx = torch.where(plane_id > 0, plane_id, -1)
        num_planes = read(surviving.sum())

        # plane table (anchor-pure means, all-member fallback); ids beyond
        # max_planes are dropped from the table
        in_table = (plane_id > 0) & (plane_id <= max_planes)
        seg = torch.where(in_table, plane_id - 1, max_planes).long()
        fin_payload = stats_payload(label, plane_id > 0, with_sq=False)
        # max_planes: dropped
        acc_fin = fold_sums(seg, fin_payload, max_planes)
        plane_normal, plane_center, _r_fin, cnt_f = _acc_models(acc_fin)
        cnt = cnt_f.to(torch.int32)
        plane_normal = torch.where((cnt > 0)[:, None], plane_normal, 0.0)
        plane_center = torch.where((cnt > 0)[:, None], plane_center, 0.0)
        diagnostics = torch.tensor(
            [peak_live, peak_over, max(num_planes - max_planes, 0),
             int(unconverged)], dtype=torch.int32,
        )
    return SegmentationResult(
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normal=plane_normal,
        plane_center=plane_center,
        plane_count=cnt,
        num_sweeps=sweeps_used,
        diagnostics=diagnostics,
        host_syncs=syncs,
        timings=timings,
    )
