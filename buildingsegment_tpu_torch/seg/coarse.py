"""Multigrid region growing — coarse label propagation + fine refinement.

Port of ``segment_planes_multigrid`` from
``buildingsegment_tpu/seg/coarse.py`` (single device, the kernel
branch of every step).  On a Morton-sorted cloud, G consecutive rows
are almost always samples of one plane, so:

1. **Coarsen**: groups of G rows become super-points (masked mean
   position, normalized mean canonical normal) with a coherence flag
   (normals aligned, points in a thin band, spatially tight); the fine
   seed rule (:func:`window_seeds`, the seed-sweep kernel) marks the
   groups holding a seed.
2. **Coarse solve**: the same machinery one level down
   (``levels > 1``), or the window solver (:func:`segment_planes`) with
   the group seeds as ``seed_override``.
3. **Refine**: each group's plane id expands to its rows; ``refine``
   sweeps against the coarse plane table (the refine-sweep kernel) drop
   rows their plane rejects and let rejected or unlabeled rows take the
   smallest accepting id of their window.
4. **Finalize**: per-plane payload sums with second moments about the
   coarse centers (the payload-moment kernel); the [P, P] coplanar pair
   test with the predicted merged RMS, union by min, flatness per root;
   hole adoption against the 128 largest flat roots (the adoption
   kernel); cull (> th_point_count), renumber through the rank lookup
   (the lookup kernel), dense plane table.  ``heal`` trims the outermost
   finalize: "merge" skips the adoption; False skips the merge too and
   takes the plain segment sums (the segment-sum kernel) in place of
   the payload-moment pass.

The [P, P] work runs on the first ``n_live`` table rows only: every
plane id is at most ``n_live``, so the other rows are empty and take no
part in a pair, a merge or a root.

Sharded (``shard_group``, the JAX package's ``axis_name``): each rank
coarsens and refines its own rows (S must divide by ``group **
levels``, so a group of rows never straddles two ranks), the seed and refine
sweeps read ring halos, the coarse solve is the sharded
:func:`segment_planes`, and the finalize's sums — the payload moments
and the adoption sums — continue from rank to rank (``group.fold``), so
the [P, P] work runs on the same table on every rank.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from buildingsegment_tpu_torch.ops.adopt import adopt_table, plane_adopt
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.prefix import prefix_sum_i32
from buildingsegment_tpu_torch.ops.segsum import (
    plane_payload_moment_sums,
    plane_sums,
    row_order_sums,
    table_lookup,
)
from buildingsegment_tpu_torch.ops.window_sweep import (
    halo_columns,
    refine_sweep,
)
from buildingsegment_tpu_torch.seg.region_grow import (
    SegmentationResult,
    _shard_kw,
    segment_planes,
    window_seeds,
)
from buildingsegment_tpu_torch.utils.device import synchronize

__all__ = ["segment_planes_multigrid", "HEAL_MODES"]

#: hole-adoption table width (the TPU kernel's lane count)
ADOPT_K = 128
#: union-by-min jump rounds of the finalize (cover any chain ≤ 4096)
MERGE_JUMPS = 12
#: ``heal`` values: the full heal (merge and hole adoption), the merge
#: alone, neither
HEAL_MODES = (True, "merge", False)


def _group_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 of [ng, G, ...] in index order."""
    out = a[:, 0]
    for j in range(1, a.shape[1]):
        out = out + a[:, j]
    return out


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp_min(_dot3(v, v), 1e-20))[..., None]


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, B] table of a_i · b_j."""
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]
            + a[:, None, 2] * b[None, :, 2])


def _add_timing(timings: dict, key: str, t0: float, dev) -> float:
    synchronize(dev)
    t1 = time.perf_counter()
    timings[key] = timings.get(key, 0.0) + (t1 - t0)
    return t1


def segment_planes_multigrid(
    positions: torch.Tensor,
    normals: torch.Tensor,
    mask: torch.Tensor,
    *,
    kth_sq_dist: Optional[torch.Tensor] = None,
    max_edge_dist: Optional[float] = None,
    curvature: Optional[torch.Tensor] = None,
    th_seed_curvature: Optional[float] = None,
    th_thickness: float = 300.0,
    th_normal_cos: float = 0.88,
    th_point_count: int = 400,
    max_planes: int = 4096,
    max_sweeps: int = 64,
    convergence_tol: float = 0.0,
    signed_normals: bool = False,
    window: int = 16,
    group: int = 8,
    refine_sweeps: int = 2,
    levels: int = 1,
    th_anchor_cos: float = 0.95,
    seed_override: Optional[torch.Tensor] = None,
    compact: Optional[bool] = None,
    seed_source: Optional[str] = None,
    seed_mode: Optional[str] = None,
    spacing_hint_mm: Optional[float] = None,
    heal=True,
    shard_group=None,
) -> SegmentationResult:
    """Multigrid windowized plane segmentation (Morton-sorted input).

    Same contract as :func:`segment_planes`; ``group`` is the coarsening
    factor (must divide N).  ``kth_sq_dist`` f32[N] is the seed ball of
    the fine seed rule (without it the ball is the edge gate squared).
    ``seed_source="coarse"`` derives the group seeds from the coherence
    statistics instead (no seed sweep; a different criterion).
    ``seed_mode`` picks the fine seed sweep's variant
    (``region_grow.SEED_MODES``; "mxu" = block form).

    ``heal`` (one of :data:`HEAL_MODES`) trims this level's finalize:
    True runs the coplanar merge and the hole adoption, "merge" the
    merge alone, False neither (identity union, the segment sums of
    ``plane_sums``).  The inner levels always heal fully, as in the JAX
    package (an inner adoption feeds the next level's refinement); the
    switch is a perf-attribution knob, and True is what production runs.

    ``shard_group`` (a ``dist.ShardGroup``; the keyword the other
    solvers call ``group``, which here is the coarsening factor, as in
    the JAX package): the inputs are this rank's rows of the sorted
    cloud (module docstring); ``heal=False`` has no sharded form.
    """
    if heal not in HEAL_MODES:
        raise ValueError(f"heal={heal!r}, expected one of {HEAL_MODES}")
    if shard_group is not None and heal is False:
        raise ValueError("sharded multigrid: heal=False has no sharded "
                         "finalize")
    t_start = time.perf_counter()
    dev = positions.device
    n = positions.shape[0]
    if n % group:
        raise ValueError(f"N={n} must be a multiple of group={group}")
    ng = n // group
    timings = {}
    pos = positions.float()
    nrm = normals.float()
    cmag = (lambda x: x) if signed_normals else torch.abs
    cn = nrm if signed_normals else canonicalize_normals(nrm)
    edge_mm = float(
        max_edge_dist if max_edge_dist is not None else 2.0 * th_thickness
    )
    # the child level's edge gate follows the proven density hint (or
    # grows by √group per level without one) — see the JAX package
    edge_scale = max(2.0, float(group) ** 0.5)
    if spacing_hint_mm is not None:
        child_hint = edge_scale * float(spacing_hint_mm)
        child_edge = max(edge_mm, 3.0 * child_hint)
    else:
        child_hint = None
        child_edge = edge_scale * edge_mm
    edge2 = float(torch.tensor(edge_mm, dtype=torch.float32) ** 2)

    # 1. coarsen
    gpos_all = pos.reshape(ng, group, 3)
    gnrm_all = cn.reshape(ng, group, 3)
    gmask_all = mask.reshape(ng, group)
    wgt = gmask_all.float()
    cnt = _group_sum(wgt)
    safe = torch.clamp_min(cnt, 1.0)[:, None]
    gpos = _group_sum(gpos_all * wgt[:, :, None]) / safe
    gsum_n = _group_sum(gnrm_all * wgt[:, :, None])
    glen = torch.sqrt(torch.clamp_min(_dot3(gsum_n, gsum_n), 1e-20))
    gnrm = gsum_n / glen[:, None]
    align = glen / torch.clamp_min(cnt, 1.0)
    dvec = gpos_all - gpos[:, None, :]
    plane_d = torch.abs(_dot3(dvec, gnrm[:, None, :]))
    spread2 = torch.where(gmask_all, _dot3(dvec, dvec), 0.0).amax(dim=1)
    band = torch.where(gmask_all, plane_d, 0.0).amax(dim=1)
    coherent = (
        (cnt >= float(max(2, group // 2)))
        & (align >= th_normal_cos)
        & (band <= th_thickness)
        & (spread2 <= edge2)
    )
    gmask = (cnt > 0) & coherent

    # group seeds: the group holds a strict fine-level seed
    if seed_override is not None:
        fine_seed = seed_override & mask
    elif seed_source == "coarse":
        fine_seed = None
        gseed = (
            gmask & (cnt >= float(group))
            & (align >= max(th_normal_cos, 0.97))
            & (band <= 0.5 * th_thickness)
        )
        if curvature is not None and th_seed_curvature is not None:
            flat = (curvature <= th_seed_curvature) & mask
            gseed = gseed & flat.reshape(ng, group).any(dim=1)
    else:
        dk = kth_sq_dist
        if dk is None:
            dk = torch.full((n,), edge2, dtype=torch.float32, device=dev)
        fine_seed = window_seeds(
            pos, nrm, mask, dk, window=window, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, signed_normals=signed_normals,
            seed_mode=seed_mode, group=shard_group,
        )
    if fine_seed is not None:
        if curvature is not None and th_seed_curvature is not None:
            fine_seed = fine_seed & (curvature <= th_seed_curvature)
        gseed = fine_seed.reshape(ng, group).any(dim=1) & gmask
    t = _add_timing(timings, "mg_seed", t_start, dev)

    # 2. coarse solve: the next level, or the window solver on the
    # group seeds
    coarse_th = max(1, th_point_count // group // 2)
    common = dict(
        seed_override=gseed, max_edge_dist=child_edge,
        th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        th_point_count=coarse_th, max_planes=max_planes,
        max_sweeps=max_sweeps,
        # tol is in fine-point units: one coarse row stands for `group`
        convergence_tol=convergence_tol * group,
        signed_normals=signed_normals, th_anchor_cos=th_anchor_cos,
        compact=compact,
    )
    gpos_i = gpos.to(torch.int32)
    if levels > 1 and ng % group == 0:
        coarse = segment_planes_multigrid(
            gpos_i, gnrm, gmask, window=window, group=group,
            refine_sweeps=refine_sweeps, levels=levels - 1,
            spacing_hint_mm=child_hint, shard_group=shard_group, **common,
        )
    else:
        coarse = segment_planes(gpos_i, gnrm, None, gmask, group=shard_group,
                                **common)
    for key, val in coarse.timings.items():
        timings[key] = timings.get(key, 0.0) + val
    t = time.perf_counter()

    # 3. refine at full resolution against the coarse plane table
    pn = coarse.plane_normal
    pc = coarse.plane_center
    n_live = coarse.num_planes
    pid = torch.repeat_interleave(torch.clamp_min(coarse.plane_idx, 0), group)
    table = torch.stack([pn[:, 0], pn[:, 1], pn[:, 2], _dot3(pn, pc)], 1)
    pos3 = tuple(pos[:, d].contiguous() for d in range(3))
    nrm3 = tuple(nrm[:, d].contiguous() for d in range(3))
    sw_pos, sw_nrm, sw_mask = pos3, nrm3, mask
    if shard_group is not None:
        # the fixed columns take their halos once a level, the ids each
        # sweep
        sw_pos, sw_nrm, sw_mask = halo_columns(shard_group, window, pos3,
                                               nrm3, mask)
    for s in range(max(1, refine_sweeps)):
        sw_pid = pid if shard_group is None else shard_group.halo_pad(
            pid, window, fill=0)
        pid = refine_sweep(
            sw_pos, sw_nrm, sw_mask, sw_pid, table, n_live, w=window,
            th_thickness=float(th_thickness),
            th_normal_cos=float(th_normal_cos), edge_gate2=edge_mm ** 2,
            signed=signed_normals, clean=(s == 0), adopt=refine_sweeps > 0,
            **_shard_kw(shard_group),
        )
    t = _add_timing(timings, "mg_refine", t, dev)

    # 4. finalize: payload sums (+ moments about the coarse centers when
    # the merge needs them)
    sq = pos3[0] * pos3[0] + pos3[1] * pos3[1] + pos3[2] * pos3[2]
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    payload = torch.cat([ones, cn, pos, sq[:, None]], 1).contiguous()
    member = mask & (pid > 0)
    cap128 = -(-max_planes // 128) * 128
    old_row = torch.where(member, pid - 1, cap128).to(torch.int32)
    # only the first L rows can be live (every id ≤ n_live)
    L = max(min(n_live, max_planes), 1)
    rows_p = torch.arange(L, dtype=torch.int64, device=dev)
    if heal:
        acc_a, acc_mq = _fold(shard_group, lambda init: plane_payload_moment_sums(
            old_row, payload, pc, n_live, table_cap=max_planes, init=init,
        ), [(cap128, 8), (cap128, 6)])
        acc = acc_a[:L]
        acc_mq = acc_mq[:L]
    else:
        acc = plane_sums(old_row, payload, n_live, table_cap=max_planes)[:L]
    cnt_o = acc[:, 0]
    live_o = cnt_o > 0
    if heal:
        acc_o = acc
        acc, parent, acc_m, c_t = _merge_coplanar(
            acc_o, acc_mq, pc[:L], rows_p, cmag, edge_mm=edge_mm,
            th_thickness=th_thickness, th_normal_cos=th_normal_cos)
    else:
        parent = rows_p
    adopted = adopt_row = None
    if heal is True:
        adopted, adopt_row, acc = _adopt_holes(
            acc, acc_o, acc_m, c_t, parent, payload, mask & (pid == 0),
            edge_mm=edge_mm, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, signed_normals=signed_normals,
            group=shard_group)

    # cull (> th_point_count) and renumber by rank of the merged root
    keep = acc[:, 0].to(torch.int32) > th_point_count
    rank = prefix_sum_i32(keep.to(torch.int32))
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    lut = torch.cat([zero, torch.where(keep[parent] & live_o, rank[parent],
                                       0).to(torch.int32)])
    new_id = table_lookup(torch.where(member, pid, 0).to(torch.int32), lut,
                          n_live + 1)
    if adopted is not None:
        # disjoint supports: members and adopted holes
        lut2 = torch.cat([zero, torch.where(keep, rank, 0).to(torch.int32)])
        pid_adopt = torch.where(adopted, adopt_row + 1, 0).to(torch.int32)
        new_id = new_id + table_lookup(pid_adopt, lut2, n_live + 1)
    plane_idx = torch.where(new_id > 0, new_id, -1).to(torch.int32)

    # dense table: kept merged-root rows in rank order
    slot = torch.where(keep, rank - 1, L).long()
    old_of_new = torch.zeros(L + 1, dtype=torch.int64, device=dev)
    old_of_new[slot] = rows_p
    valid_new = (rows_p < rank[L - 1])[:, None]
    acc_new = torch.zeros((max_planes, 8), dtype=torch.float32, device=dev)
    acc_new[:L] = torch.where(valid_new, acc[old_of_new[:L]], 0.0)
    cnt2 = acc_new[:, 0].to(torch.int32)
    sc = torch.clamp_min(cnt2, 1).float()[:, None]
    live2 = (cnt2 > 0)[:, None]
    plane_normal = torch.where(live2, _unit(acc_new[:, 1:4] / sc), 0.0)
    plane_center = torch.where(live2, acc_new[:, 4:7] / sc, 0.0)
    num_planes = int(rank[L - 1])
    _add_timing(timings, "mg_finalize", t, dev)
    return SegmentationResult(
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normal=plane_normal,
        plane_center=plane_center,
        plane_count=cnt2,
        num_sweeps=coarse.num_sweeps,
        # the coarse counters bound the hierarchy: refine and finalize
        # create no labels
        diagnostics=coarse.diagnostics,
        host_syncs=coarse.host_syncs + 1,
        timings=timings,
    )


def _fold(group, compute, shapes):
    """``compute(None)``, or its sums continued from rank to rank."""
    if group is None:
        return compute(None)
    return group.fold(compute, shapes)


def _merge_coplanar(acc, acc_mq, pc, rows_p, cmag, *, edge_mm, th_thickness,
                    th_normal_cos):
    """The finalize's coplanar merge on the [L] table: the pair test with
    the predicted merged-plane RMS, union by min with jump doubling, the
    sums folded onto the roots.  ``acc_mq`` holds the moments about the
    coarse centers ``pc``.  Returns (root sums f32[L, 8], parent
    int64[L], each plane's moments about its own center f32[L, 6], its
    center f32[L, 3])."""
    L = acc.shape[0]
    cnt_o = acc[:, 0]
    live_o = cnt_o > 0
    sc_o = torch.clamp_min(cnt_o, 1.0)[:, None]
    n_t = _unit(acc[:, 1:4] / sc_o)
    c_t = acc[:, 4:7] / sc_o
    ccd = _dot3(c_t, c_t)
    r_t = torch.sqrt(torch.clamp_min(acc[:, 7] / sc_o[:, 0] - ccd, 0.0))
    # parallel-axis shift of the moments to each plane's own center
    dq = c_t - pc
    shift = torch.stack([dq[:, 0] * dq[:, 0], dq[:, 1] * dq[:, 1],
                         dq[:, 2] * dq[:, 2], dq[:, 0] * dq[:, 1],
                         dq[:, 0] * dq[:, 2], dq[:, 1] * dq[:, 2]], 1)
    acc_m = acc_mq - cnt_o[:, None] * shift

    # coplanar pair test with the predicted merged-plane RMS
    nc = _dot3(n_t, c_t)
    ncT = _outer(n_t, c_t)
    nrm_sep = ncT - nc[:, None]
    nrm_sep_b = nc[None, :] - ncT.T
    dotnn = _outer(n_t, n_t)
    cosab = cmag(dotnn)
    d2 = ccd[:, None] + ccd[None, :] - 2.0 * _outer(c_t, c_t)
    inplane2 = torch.clamp_min(d2 - nrm_sep * nrm_sep, 0.0)
    reach = 2.0 * (r_t[:, None] + r_t[None, :]) + edge_mm
    cntm = torch.clamp_min(cnt_o[:, None] + cnt_o[None, :], 1.0)
    q3 = [(acc[:, 4 + a][:, None] + acc[:, 4 + a][None, :]) / cntm
          for a in range(3)]
    di3 = [c_t[:, a][:, None] - q3[a] for a in range(3)]
    dj3 = [c_t[:, a][None, :] - q3[a] for a in range(3)]
    sgn = torch.where(dotnn < 0.0, -1.0, 1.0)
    nm3 = [cnt_o[:, None] * n_t[:, a][:, None]
           + sgn * cnt_o[None, :] * n_t[:, a][None, :] for a in range(3)]
    nn2 = torch.clamp_min(nm3[0] * nm3[0] + nm3[1] * nm3[1]
                          + nm3[2] * nm3[2], 1e-20)
    num = torch.zeros_like(cntm)
    for col, a, b in ((0, 0, 0), (1, 1, 1), (2, 2, 2),
                      (3, 0, 1), (4, 0, 2), (5, 1, 2)):
        mm = (acc_m[:, col][:, None] + acc_m[:, col][None, :]
              + cnt_o[:, None] * di3[a] * di3[b]
              + cnt_o[None, :] * dj3[a] * dj3[b])
        num = num + (1.0 if a == b else 2.0) * nm3[a] * nm3[b] * mm
    r2m = num / (nn2 * cntm)
    ok_pair = (
        (torch.abs(nrm_sep) <= th_thickness)
        & (torch.abs(nrm_sep_b) <= th_thickness)
        & (cosab >= th_normal_cos)
        & (inplane2 <= reach * reach)
        & (r2m <= (0.5 * th_thickness) ** 2)
        & live_o[:, None] & live_o[None, :]
    )
    # union by min + jump doubling
    parent = torch.where(ok_pair, rows_p[None, :], L).amin(dim=1)
    parent = torch.minimum(rows_p, parent)
    for _ in range(MERGE_JUMPS):
        parent = torch.minimum(parent, parent[parent])
    del ok_pair, r2m, num, mm, nm3, di3, dj3, q3, d2, inplane2, reach
    return row_order_sums(parent, acc, L), parent, acc_m, c_t


def _adopt_holes(acc, acc_o, acc_m, c_t, parent, payload, holes, *, edge_mm,
                 th_thickness, th_normal_cos, signed_normals, group=None):
    """The finalize's hole adoption: flatness per merged root, then each
    hole row tested against the 128 largest flat roots (the adoption
    kernel).  ``acc`` holds the root sums, ``acc_o``, ``acc_m`` and
    ``c_t`` each plane's own sums, moments about its center and center.
    Returns (adopted bool[n], the adopting root row int32[n], the root
    sums with the adopted rows' payload added)."""
    L = acc.shape[0]
    dev = acc.device
    cnt_o = acc_o[:, 0]
    # flatness per merged root: only a flat root adopts holes
    cnt_r = acc[:, 0]
    sc_r = torch.clamp_min(cnt_r, 1.0)[:, None]
    n_r = _unit(acc[:, 1:4] / sc_r)
    c_r = acc[:, 4:7] / sc_r
    nr_f = n_r[parent]
    cr_f = c_r[parent]
    r2n_f = (
        acc_m[:, 0] * nr_f[:, 0] * nr_f[:, 0]
        + acc_m[:, 1] * nr_f[:, 1] * nr_f[:, 1]
        + acc_m[:, 2] * nr_f[:, 2] * nr_f[:, 2]
        + 2.0 * acc_m[:, 3] * nr_f[:, 0] * nr_f[:, 1]
        + 2.0 * acc_m[:, 4] * nr_f[:, 0] * nr_f[:, 2]
        + 2.0 * acc_m[:, 5] * nr_f[:, 1] * nr_f[:, 2]
    )
    off_f = _dot3(c_t - cr_f, nr_f)
    flat_num = row_order_sums(
        parent, (r2n_f + cnt_o * off_f * off_f)[:, None], L)[:, 0]
    flat_ok = flat_num / torch.clamp_min(cnt_r, 1.0) <= (
        0.25 * th_thickness) ** 2

    # hole fill against the top-K merged planes (ties by lower row, as
    # lax.top_k)
    k = min(ADOPT_K, L)
    top_row = torch.sort(acc[:, 0], descending=True, stable=True).indices[:k]
    acc_k = acc[top_row]
    top_cnt = acc_k[:, 0]
    sck = torch.clamp_min(top_cnt, 1.0)[:, None]
    nk = _unit(acc_k[:, 1:4] / sck)
    ck = acc_k[:, 4:7] / sck
    ccdk = _dot3(ck, ck)
    rk = torch.sqrt(torch.clamp_min(acc_k[:, 7] / sck[:, 0] - ccdk, 0.0))
    bk = _dot3(nk, ck)
    reachk = 2.0 * rk + edge_mm
    lane_ok = (top_cnt > 0) & flat_ok[top_row]
    lane_rows = torch.zeros(ADOPT_K, dtype=torch.int32, device=dev)
    lane_rows[:k] = top_row.to(torch.int32)
    table = adopt_table(nk, ck, bk, ccdk, reachk * reachk, lane_ok)
    hold = {}

    def adopt(init):
        hold["out"] = plane_adopt(
            payload, holes, table, lane_rows,
            th_thickness=float(th_thickness), th_cos=float(th_normal_cos),
            signed=signed_normals, init=init)
        return hold["out"][2]

    acc128 = _fold(group, adopt, (ADOPT_K, 8))
    adopted, adopt_row, _ = hold["out"]
    # fold the lane sums onto their root rows (top_row is a permutation)
    return adopted, adopt_row, acc.index_add(0, top_row, acc128[:k])
