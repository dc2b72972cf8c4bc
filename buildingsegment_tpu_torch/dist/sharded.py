"""The sharded end-to-end pipeline: one process a Morton-range shard.

Port of ``buildingsegment_tpu/dist/sharded.py``.  The JAX package runs
one SPMD program over a device mesh (``shard_map``); here every rank is
a process with its own :class:`~buildingsegment_tpu_torch.dist.ShardGroup`
and runs the same Python, so each rank's host reads the same reduced
values and takes the same path:

* stage 1: every rank takes the whole input, runs ``shift_to_origin``
  and the global Morton sort (the same on every rank) and keeps its own
  contiguous row range — the port's form of JAX's one global sort;
* the stats sweep, the seed sweep, label propagation and refinement run
  on the rank's rows with ring halos of the neighbours' rows
  (``dist/halo.py``);
* the label tables are reduced over the ranks: integer tables and the
  merge parents by ``all_reduce``, f32 sums rank after rank in a fixed
  order (``ShardGroup.fold``), so every rank holds the same tables;
* output: the labels are all-gathered and unsorted on every rank; the
  plane table is the same everywhere (JAX's replicated out_specs).

Per sweep a rank moves O(w) halo rows and O(labels) table rows, never
the whole cloud.  The result equals the one-device run of the same path
(``pipeline.run_device_pipeline``) bit for bit, with the compact loop
off above world 1 (it has no sharded form).

The edge gate and the anchor rule follow ``run_device_pipeline``'s:
the fine gate widens with the proven spacing hint, and ``seg_anchor_cos``
None leaves each solver its default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu_torch.core.morton import morton_sort, unsort_labels
from buildingsegment_tpu_torch.core.quantize import shift_to_origin
from buildingsegment_tpu_torch.dist.mesh import ShardGroup, shard_rows
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu_torch.seg.coarse import segment_planes_multigrid
from buildingsegment_tpu_torch.seg.region_grow import (
    segment_planes,
    window_seeds,
)

__all__ = [
    "sharded_pipeline",
    "sharded_seg_body",
    "sharded_stats_body",
    "sharded_grow_body",
]


def _mg_path(config: PipelineConfig, s: int) -> bool:
    """The multigrid path applies when the shard's rows divide evenly
    into the coarsening hierarchy."""
    return config.seg_group > 1 and s % (
        config.seg_group ** config.seg_levels) == 0


def sharded_stats_body(group: ShardGroup, config: PipelineConfig):
    """The neighbourhood stage on this rank's sorted rows:
    ``fn(spos f32[S, 3], smask bool[S])`` → the multigrid path's
    ``(kth_sq_dist, normals, curvature)`` or the fused sweep's
    ``(neigh_idx, neigh_sq_dist, normals, curvature)`` (global rows)."""
    def body(spos, smask):
        if _mg_path(config, spos.shape[0]):
            return knn_normals_window_stats(
                spos, smask, k=config.knn_k, window=config.knn_window,
                radius=config.normal_radius, max_nn=config.normal_max_nn,
                rank_mode=config.stats_rank_mode, group=group,
            )
        return knn_normals_window_sorted(
            spos, smask, k=max(config.knn_k, 16), window=config.knn_window,
            radius=config.normal_radius, max_nn=config.normal_max_nn,
            group=group,
        )

    return body


def sharded_grow_body(group: ShardGroup, config: PipelineConfig, *,
                      signed_normals: bool = False):
    """The segmentation stage: ``fn(spos, smask, *stats)`` →
    ``SegmentationResult`` with this rank's labels and the plane
    table every rank shares."""
    knn_k = config.knn_k

    def body(spos, smask, *stats):
        # the fine edge gate widens with the proven density hint, as in
        # run_device_pipeline (else N shards ≢ 1 shard)
        edge0 = 2.0 * config.th_thickness
        if config.spacing_hint_mm is not None:
            edge0 = max(edge0, 3.0 * config.spacing_hint_mm)
        seg_kwargs = dict(
            max_edge_dist=edge0, th_seed_curvature=config.th_seed_curvature,
            th_thickness=config.th_thickness,
            th_normal_cos=config.th_normal_cos,
            th_point_count=config.th_point_count,
            max_planes=config.max_planes, max_sweeps=config.max_sweeps,
            convergence_tol=config.seg_convergence_tol,
            signed_normals=signed_normals, compact=config.seg_compact,
        )
        # None → the solver's own default, as in run_device_pipeline
        if config.seg_anchor_cos is not None:
            seg_kwargs["th_anchor_cos"] = config.seg_anchor_cos
        if _mg_path(config, spos.shape[0]):
            dk, normals, curv = stats
            return segment_planes_multigrid(
                spos, normals, smask, kth_sq_dist=dk, curvature=curv,
                group=config.seg_group, levels=config.seg_levels,
                refine_sweeps=config.seg_refine_sweeps,
                seed_source=config.seg_seed_source,
                seed_mode=config.seg_seed_mode,
                spacing_hint_mm=config.spacing_hint_mm, shard_group=group,
                **seg_kwargs,
            )
        neigh_idx, neigh_d, normals, curv = stats
        seeds = window_seeds(
            spos, normals, smask, neigh_d[:, knn_k - 1],
            window=config.knn_window, th_thickness=config.th_thickness,
            th_normal_cos=config.th_normal_cos,
            signed_normals=signed_normals, seed_mode=config.seg_seed_mode,
            group=group,
        )
        return segment_planes(
            spos, normals, neigh_idx[:, :knn_k], smask,
            neigh_sq_dist=neigh_d[:, :knn_k], curvature=curv,
            seed_override=seeds, propagation="window", group=group,
            **seg_kwargs,
        )

    return body


def sharded_seg_body(group: ShardGroup, config: PipelineConfig, *,
                     signed_normals: bool = False):
    """The whole sharded core: this rank's sorted rows → its labels
    (:func:`sharded_stats_body` then :func:`sharded_grow_body`)."""
    stats = sharded_stats_body(group, config)
    grow = sharded_grow_body(group, config, signed_normals=signed_normals)

    def body(spos, smask):
        return grow(spos, smask, *stats(spos, smask))

    return body


def sharded_pipeline(
    group: ShardGroup,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    signed_normals: bool = False,
    capacity_hint: Optional[int] = None,
):
    """Build this rank's sharded pipeline function.

    Returns ``fn(positions int32[N, 3], mask bool[N])`` →
    ``(shifted_positions, bbox_min, SegmentationResult)``, every rank
    called with the whole input on ``group.device``.  ``plane_idx`` is
    the whole cloud's labels in input order on every rank; the plane
    table, ``num_planes`` and the counters are the same on every rank.
    ``host_syncs`` adds the rank's host stagings (gloo with a card) to
    the solve's host reads.  N must divide by the world size, and where
    N takes the multigrid path (``seg_group ** seg_levels`` divides it)
    so must each shard.  Always the window path (the only one whose
    work splits by shards).
    """
    del capacity_hint  # kept for the JAX package's signature
    stats = sharded_stats_body(group, config)
    grow = sharded_grow_body(group, config, signed_normals=signed_normals)

    def fn(positions: torch.Tensor, mask: torch.Tensor):
        n = positions.shape[0]
        rows = shard_rows(n, group)
        s = rows.stop - rows.start
        if _mg_path(config, n) and not _mg_path(config, s):
            span = config.seg_group ** config.seg_levels
            raise ValueError(
                f"{n} rows take the multigrid path but a shard of {s} does "
                f"not divide by seg_group ** seg_levels = {span}; pad the "
                f"capacity to a multiple of {group.world * span}")
        positions = positions.to(group.device)
        mask = mask.to(group.device)
        stagings0 = group.stats.host_stagings
        shifted, lo, _hi = shift_to_origin(positions, mask)
        # the global sort, the same on every rank; each keeps its rows
        spos, smask, order = morton_sort(shifted, mask, config.morton_small)
        spos_r = spos[rows].float().contiguous()
        smask_r = smask[rows].contiguous()
        seg = grow(spos_r, smask_r, *stats(spos_r, smask_r))
        labels = group.all_gather(seg.plane_idx)
        plane_idx = unsort_labels(order, labels)
        syncs = seg.host_syncs + group.stats.host_stagings - stagings0
        return shifted, lo, dataclasses.replace(
            seg, plane_idx=plane_idx, host_syncs=syncs)

    return fn
