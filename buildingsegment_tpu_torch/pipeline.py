"""End-to-end segmentation pipeline of the port.

Port of the window path of ``buildingsegment_tpu/pipeline.py`` — the
reference's ``main()`` (tmc3/TMC3.cpp:202-229):

    read PLY (×1000 → integer mm)          ply::read, TMC3.cpp:208
    → bbox shift to origin                 buildingSeg ctor, TMC3.cpp:55-79
    → Morton sort, window kNN + normals    get_Normal_and_K_neighbor, :215
    → region-growing plane segmentation    seg_plane::get_planes, :217
    → per-plane random colors              set_plane_color, :218
    → write labeled binary PLY             ply::write, :221

Host I/O at the edges (the port's numpy PLY codec), PyTorch on an
explicit device in the middle.  The written cloud is the *shifted* one,
as the reference's constructor mutates the caller's cloud in place.

Every ``knn_method`` runs:

* ``"window"`` — what ``"auto"`` resolves to above 65,536 points — in
  both of its forms: with ``seg_group > 1`` (the default, when the
  capacity is a multiple of ``seg_group ** seg_levels``) the stats sweep
  feeds the multigrid solver, otherwise the fused kNN sweep feeds the
  single-level window solver;
* ``"brute"`` — what ``"auto"`` resolves to at 65,536 points or fewer —
  and ``"pallas"``: the exact-kNN path (:func:`_classic_pipeline`),
  exact kNN graph → gather normals → graph propagation, in the input
  order; "pallas" computes the kNN on kernel #14.

``segment_files`` is the multi-scan pipeline (BASELINE config 5): a
reader thread prefetches scans, the main thread runs the device
pipeline, a writer thread fetches, colorizes and writes each labeled PLY
and, with ``render_dir``, the three ortho PNGs (``raster/ortho.py``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.core.morton import (
    morton_argsort,
    morton_sort,
    unsort_labels,
)
from buildingsegment_tpu_torch.core.pointset import PointBatch
from buildingsegment_tpu_torch.core.quantize import (
    dedup_keep_mask,
    estimate_spacing_mm,
    shift_to_origin,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.knn import knn
from buildingsegment_tpu_torch.ops.normals import estimate_normals
from buildingsegment_tpu_torch.ops.pallas_knn import knn_pallas
from buildingsegment_tpu_torch.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu_torch.profiling import annotate
from buildingsegment_tpu_torch.raster.ortho import dispatch_ortho, finish_ortho
from buildingsegment_tpu_torch.seg.coarse import segment_planes_multigrid
from buildingsegment_tpu_torch.seg.colorize import colorize_planes
from buildingsegment_tpu_torch.seg.region_grow import segment_planes
from buildingsegment_tpu_torch.utils.device import synchronize

__all__ = [
    "PipelineOutput",
    "dump_stages",
    "run_device_pipeline",
    "resolve_knn_method",
    "segment_cloud",
    "segment_file",
    "segment_files",
]


def resolve_knn_method(config: PipelineConfig, capacity: int) -> str:
    """'auto' → 'brute' at capacity ≤ knn_auto_threshold, else 'window'."""
    if config.knn_method != "auto":
        return config.knn_method
    return "brute" if capacity <= config.knn_auto_threshold else "window"


@dataclasses.dataclass
class PipelineOutput:
    """Host-side results of one pipeline run."""

    cloud: HostPointCloud          # shifted positions + label colors
    plane_idx: np.ndarray          # int32[N] (1..P or -1), input order
    num_planes: int
    plane_normals: np.ndarray      # float32[P, 3]
    plane_centers: np.ndarray      # float32[P, 3]
    plane_counts: np.ndarray       # int32[P]
    bbox_min: np.ndarray           # int32[3] original-cloud bbox min
    timings: dict                  # stage → seconds
    num_sweeps: int = 0
    host_syncs: int = 0
    diagnostics: dict = dataclasses.field(default_factory=dict)
    # the run's shifted positions int32[C, 3] in input order (padding rows
    # hold PAD_COORD) and mask bool[C], on the run's device: the raster
    # reads them without a re-upload (None on segment_files' outputs)
    device_shifted: Optional[torch.Tensor] = None
    device_mask: Optional[torch.Tensor] = None


def run_device_pipeline(
    positions: torch.Tensor,
    mask: torch.Tensor,
    *,
    k_search: int,
    knn_k: int,
    normal_radius: float,
    normal_max_nn: int,
    th_thickness: float,
    th_normal_cos: float,
    th_point_count: int,
    max_planes: int,
    max_sweeps: int,
    signed_normals: bool = False,
    knn_method: str = "window",
    knn_window_size: int = 64,
    th_seed_curvature=None,
    convergence_tol: float = 0.0,
    seg_group: int = 1,
    seg_levels: int = 1,
    seg_refine_sweeps: int = 2,
    seg_anchor_cos=None,
    seg_compact=None,
    seg_seed_source=None,
    seg_seed_mode=None,
    stats_rank_mode=None,
    morton_small: bool = False,
    spacing_hint_mm=None,
    timings: Optional[dict] = None,
):
    """The on-device part: shift → kNN → normals → segmentation.

    ``k_search`` is the kNN width of the exact-kNN paths ("brute",
    "pallas"); the window path reads ``knn_k``.  Returns (shifted
    positions, bbox_min, SegmentationResult with ``plane_idx`` in input
    order).  ``stats_rank_mode`` and ``seg_seed_mode`` ("mxu": the
    block-form stats and fine seed sweeps) apply to the multigrid window
    path, as in the JAX package.  ``timings``, when given, receives
    per-stage seconds (each stage ends in a device synchronize).
    """
    timings = {} if timings is None else timings
    if knn_method in ("brute", "pallas"):
        return _classic_pipeline(
            positions, mask, k_search=k_search, knn_k=knn_k,
            normal_radius=normal_radius, normal_max_nn=normal_max_nn,
            th_thickness=th_thickness, th_normal_cos=th_normal_cos,
            th_point_count=th_point_count, max_planes=max_planes,
            max_sweeps=max_sweeps, signed_normals=signed_normals,
            knn_method=knn_method, th_seed_curvature=th_seed_curvature,
            convergence_tol=convergence_tol, timings=timings,
        )
    if knn_method != "window":
        raise ValueError(f"knn_method={knn_method!r}")
    use_stats = (
        seg_group > 1 and positions.shape[0] % (seg_group ** seg_levels) == 0
    )
    dev = positions.device
    t0 = time.perf_counter()
    with annotate("stage1"):
        shifted, lo, _hi = shift_to_origin(positions, mask)
        spos, smask, order = morton_sort(shifted, mask, morton_small)
        if use_stats:
            # the multigrid solver consumes only the k-th-NN distance
            # (the seed ball), never the sorted neighbour lists
            dk, normals, curv = knn_normals_window_stats(
                spos.float(), smask, k=knn_k, window=knn_window_size,
                radius=normal_radius, max_nn=normal_max_nn,
                rank_mode=stats_rank_mode,
            )
        else:
            neigh_idx, neigh_d, normals, curv = knn_normals_window_sorted(
                spos.float(), smask, k=max(knn_k, 16),
                window=knn_window_size, radius=normal_radius,
                max_nn=normal_max_nn,
            )
        synchronize(dev)
    t1 = time.perf_counter()
    timings["stage1"] = t1 - t0

    # fine-level edge gate: widened past 2·thickness on sparse scans
    # when the density hint is proven
    edge0 = 2.0 * th_thickness
    if spacing_hint_mm is not None:
        edge0 = max(edge0, 3.0 * spacing_hint_mm)
    seg_kwargs = dict(
        max_edge_dist=edge0, th_seed_curvature=th_seed_curvature,
        th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        th_point_count=th_point_count, max_planes=max_planes,
        max_sweeps=max_sweeps, convergence_tol=convergence_tol,
        signed_normals=signed_normals, compact=seg_compact,
    )
    if seg_anchor_cos is not None:
        seg_kwargs["th_anchor_cos"] = seg_anchor_cos
    with annotate("segmentation"):
        if use_stats:
            seg = segment_planes_multigrid(
                spos, normals, smask, kth_sq_dist=dk, curvature=curv,
                group=seg_group, levels=seg_levels,
                refine_sweeps=seg_refine_sweeps, seed_source=seg_seed_source,
                seed_mode=seg_seed_mode, spacing_hint_mm=spacing_hint_mm,
                **seg_kwargs,
            )
        else:
            seg = segment_planes(
                spos, normals, neigh_idx[:, :knn_k], smask,
                neigh_sq_dist=neigh_d[:, :knn_k], curvature=curv,
                **seg_kwargs,
            )
    t2 = time.perf_counter()
    timings["segmentation"] = t2 - t1
    timings.update(seg.timings)
    with annotate("unsort"):
        plane_idx = unsort_labels(order, seg.plane_idx)
        synchronize(dev)
    timings["unsort"] = time.perf_counter() - t2
    return shifted, lo, dataclasses.replace(seg, plane_idx=plane_idx)


def _classic_pipeline(
    positions, mask, *, k_search, knn_k, normal_radius, normal_max_nn,
    th_thickness, th_normal_cos, th_point_count, max_planes, max_sweeps,
    signed_normals, knn_method, th_seed_curvature, convergence_tol, timings,
):
    """The exact-kNN paths ("brute", "pallas"): shift → exact kNN graph
    (k_search wide) → gather normals → graph propagation over the first
    ``knn_k`` slots, all in the input order."""
    dev = positions.device
    t0 = time.perf_counter()
    with annotate("knn"):
        shifted, lo, _hi = shift_to_origin(positions, mask)
        if knn_method == "pallas":
            # Morton-sort first so the candidate tiles are spatially
            # coherent and the box pruning bites; ids map back through
            # ``order`` and the rows scatter into the input frame
            order = morton_argsort(shifted, mask)
            s_idx, s_d = knn_pallas(shifted[order], mask[order], k=k_search)
            neigh_idx = torch.empty_like(s_idx)
            neigh_d = torch.empty_like(s_d)
            neigh_idx[order] = order[s_idx.long()].to(torch.int32)
            neigh_d[order] = s_d
        else:
            neigh_idx, neigh_d = knn(shifted, mask, k=k_search)
        synchronize(dev)
    t1 = time.perf_counter()
    timings["knn"] = t1 - t0
    with annotate("normals"):
        normals, curv = estimate_normals(
            shifted, mask, neigh_idx, neigh_d, radius=normal_radius,
            max_nn=normal_max_nn,
        )
        synchronize(dev)
    t2 = time.perf_counter()
    timings["normals"] = t2 - t1
    timings["stage1"] = t2 - t0
    with annotate("segmentation"):
        seg = segment_planes(
            shifted, normals, neigh_idx[:, :knn_k], mask, curvature=curv,
            th_seed_curvature=th_seed_curvature, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, th_point_count=th_point_count,
            max_planes=max_planes, max_sweeps=max_sweeps,
            convergence_tol=convergence_tol, signed_normals=signed_normals,
            propagation="graph",
        )
    timings["segmentation"] = time.perf_counter() - t2
    timings.update(seg.timings)
    return shifted, lo, seg


def _maybe_dedup(cloud: HostPointCloud, config: PipelineConfig):
    """Opt-in quantized dedup (config.dedup_bits) before upload."""
    if config.dedup_bits is None:
        return cloud
    keep = dedup_keep_mask(cloud.positions, config.dedup_bits)
    return cloud if keep.all() else cloud.select(keep)


def _prepare_upload(cloud: HostPointCloud, config: PipelineConfig, device):
    """Host bbox shift + padded upload.  Returns (batch, shifted_host
    int32[N, 3], lo_host int32[3]); the device shift is then exactly 0
    per axis, so host and device agree on every coordinate."""
    n = cloud.count
    capacity = config.padded_count(n)
    if n:
        lo_h = cloud.positions.min(axis=0).astype(np.int32)
        shifted_h = (cloud.positions - lo_h[None, :]).astype(np.int32)
    else:
        lo_h = np.zeros(3, np.int32)
        shifted_h = np.zeros((0, 3), np.int32)
    batch = PointBatch.upload(shifted_h, capacity=capacity, device=device)
    return batch, shifted_h, lo_h


def _prove_morton_small(config: PipelineConfig, shifted_h) -> PipelineConfig:
    """One-key Morton sort when the host bbox proves every coordinate
    < 2^20."""
    if config.morton_small or shifted_h.size == 0:
        return config
    if int(shifted_h.max()) < (1 << 20):
        return dataclasses.replace(config, morton_small=True)
    return config


def _prove_spacing(config: PipelineConfig, shifted_h) -> PipelineConfig:
    """Measure the scan density on the host and set the (power-of-two
    bucketed) spacing hint that widens the edge gate on sparse scans."""
    if config.spacing_hint_mm is not None or shifted_h.size == 0:
        return config
    hint = spacing_bucket_mm(estimate_spacing_mm(shifted_h))
    return dataclasses.replace(config, spacing_hint_mm=hint)


def _upload(cloud: HostPointCloud, config: PipelineConfig, dev):
    """Host bbox shift, padded upload and the proven hints.  Returns
    (batch, shifted_host, lo_host, config with the hints); the upload is
    complete on return."""
    batch, shifted_h, lo_h = _prepare_upload(cloud, config, dev)
    config = _prove_morton_small(config, shifted_h)
    config = _prove_spacing(config, shifted_h)
    synchronize(dev)
    return batch, shifted_h, lo_h, config


def _run_device(batch: PointBatch, config: PipelineConfig,
                signed_normals: bool, timings: dict):
    """``run_device_pipeline`` on the batch under ``config``; returns
    (shifted positions, SegmentationResult)."""
    shifted, _lo, seg = run_device_pipeline(
        batch.positions, batch.mask,
        k_search=max(config.knn_k_pad, config.normal_max_nn),
        knn_k=config.knn_k,
        normal_radius=config.normal_radius,
        normal_max_nn=config.normal_max_nn,
        th_thickness=config.th_thickness,
        th_normal_cos=config.th_normal_cos,
        th_point_count=config.th_point_count,
        max_planes=config.max_planes,
        max_sweeps=config.max_sweeps,
        signed_normals=signed_normals,
        knn_method=resolve_knn_method(config, batch.capacity),
        knn_window_size=config.knn_window,
        th_seed_curvature=config.th_seed_curvature,
        convergence_tol=config.seg_convergence_tol,
        seg_group=config.seg_group,
        seg_levels=config.seg_levels,
        seg_refine_sweeps=config.seg_refine_sweeps,
        seg_anchor_cos=config.seg_anchor_cos,
        seg_compact=config.seg_compact,
        seg_seed_source=config.seg_seed_source,
        seg_seed_mode=config.seg_seed_mode,
        stats_rank_mode=config.stats_rank_mode,
        morton_small=config.morton_small,
        spacing_hint_mm=config.spacing_hint_mm,
        timings=timings,
    )
    return shifted, seg


def _finish_output(cloud, shifted_h, lo_h, shifted, mask, seg, config,
                   timings, t0) -> PipelineOutput:
    """Fetch the labels and the plane table, colorize; ``timings["total"]``
    runs from ``t0``."""
    t2 = time.perf_counter()
    n = cloud.count
    num_planes = seg.num_planes
    with annotate("device_to_host"):
        plane_idx = seg.plane_idx[:n].cpu().numpy().astype(np.int32)
        p_count = seg.plane_count[:num_planes].cpu().numpy()
        p_normal = seg.plane_normal[:num_planes].cpu().numpy()
        p_center = seg.plane_center[:num_planes].cpu().numpy()
        diag = seg.diagnostics.cpu().numpy()
    t3 = time.perf_counter()
    timings["device_to_host"] = t3 - t2

    with annotate("colorize"):
        colors = colorize_planes(
            plane_idx, num_planes, low=config.color_low,
            rng_range=config.color_range,
        )
    # attribute passthrough: the reference's writer keeps reflectance
    # and frame index beside the new label colors (tmc3/ply.cpp:131-136)
    out_cloud = HostPointCloud(
        positions=shifted_h,
        colors=colors,
        reflectances=cloud.reflectances,
        frame_idx=cloud.frame_idx,
        laser_angles=cloud.laser_angles,
    )
    t4 = time.perf_counter()
    timings["colorize_host"] = t4 - t3
    timings["total"] = t4 - t0
    timings["mpoints_per_sec"] = n / max(timings["total"], 1e-9) / 1e6
    return PipelineOutput(
        cloud=out_cloud,
        plane_idx=plane_idx,
        num_planes=num_planes,
        plane_normals=p_normal,
        plane_centers=p_center,
        plane_counts=p_count,
        bbox_min=lo_h,
        timings=timings,
        num_sweeps=seg.num_sweeps,
        host_syncs=seg.host_syncs,
        diagnostics={
            "peak_live_labels": int(diag[0]),
            "labels_over_merge_cap": int(diag[1]),
            "planes_over_capacity": int(diag[2]),
            "hit_max_sweeps": int(diag[3]),
        },
        device_shifted=shifted,
        device_mask=mask,
    )


def segment_cloud(
    cloud: HostPointCloud,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    device="cuda",
    signed_normals: bool = False,
) -> PipelineOutput:
    """Segment an in-memory cloud on ``device``; returns the labeled
    output + plane table."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    timings = {}
    cloud = _maybe_dedup(cloud, config)
    batch, shifted_h, lo_h, config = _upload(cloud, config, dev)
    t1 = time.perf_counter()
    timings["host_to_device"] = t1 - t0

    shifted, seg = _run_device(batch, config, signed_normals, timings)
    timings["device_pipeline"] = time.perf_counter() - t1
    return _finish_output(cloud, shifted_h, lo_h, shifted, batch.mask, seg,
                          config, timings, t0)


def dump_stages(
    output: PipelineOutput, path: str, *, include_graph: bool = False,
    config: PipelineConfig = DEFAULT_CONFIG, device="cuda",
) -> None:
    """Write a run's stage outputs to ``path`` (.npz): the shifted
    positions, labels and plane table — the structured, opt-in analog of
    the reference's mid-pipeline debug PLY (tmc3/my_function.h:81).

    With ``include_graph`` the kNN lists, normals and curvature are
    recomputed on ``device`` by the fused window sweep under ``config``
    (in the Morton frame, then unsorted) and saved beside them: the
    stage to look at when a segmentation changes.  Keys, dtypes and
    shapes are the JAX package's.
    """
    extra = {}
    if include_graph:
        pos_h = output.cloud.positions
        n = pos_h.shape[0]
        batch = PointBatch.upload(pos_h, config.padded_count(n), device=device)
        order = morton_argsort(batch.positions, batch.mask)
        idx, d, nrm, curv = knn_normals_window_sorted(
            batch.positions[order].float(), batch.mask[order],
            k=max(config.knn_k, 16), window=config.knn_window,
            radius=config.normal_radius, max_nn=config.normal_max_nn,
        )
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        keep = inv[:n]
        extra = {
            "neigh_idx": order[idx.long()][keep].to(torch.int32).cpu().numpy(),
            "neigh_sq_dist": d[keep].cpu().numpy(),
            "normals": nrm[keep].cpu().numpy(),
            "curvature": curv[keep].cpu().numpy(),
        }
    np.savez_compressed(
        path,
        positions=output.cloud.positions,
        plane_idx=output.plane_idx,
        plane_normals=output.plane_normals,
        plane_centers=output.plane_centers,
        plane_counts=output.plane_counts,
        bbox_min=output.bbox_min,
        num_planes=output.num_planes,
        **extra,
    )


def segment_file(
    input_path: str,
    output_path: str,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    device="cuda",
    signed_normals: bool = False,
) -> PipelineOutput:
    """File-to-file pipeline with the reference's I/O contract: input
    positions × ``position_scale`` (1000 → mm, TMC3.cpp:207), output at
    scale 1.0 / offset 0 as binary (TMC3.cpp:221)."""
    t0 = time.perf_counter()
    cloud = read_ply(input_path, position_scale=config.position_scale)
    t_read = time.perf_counter() - t0

    out = segment_cloud(
        cloud, config, device=device, signed_normals=signed_normals
    )

    t1 = time.perf_counter()
    write_ply(
        out.cloud,
        output_path,
        position_scale=config.output_scale,
        position_offset=(0.0, 0.0, 0.0),
        ascii=not config.output_binary,
    )
    out.timings["read_ply"] = t_read
    out.timings["write_ply"] = time.perf_counter() - t1
    out.timings["total_with_io"] = time.perf_counter() - t0
    return out


def _bucket_capacity(n: int, config: PipelineConfig) -> int:
    """Round capacity to an eighth-octave bucket ≥ padded_count.

    Buckets are 2^k × {1, 1.125, 1.25, ..., 1.875}, each re-aligned to
    ``pad_to_multiple``: at most ~12.5% padding at scale.  In the JAX
    package the buckets let scans share one compiled program; the port
    keeps them because the capacity decides the padding, and so which
    rows the multigrid groups hold: a multi-scan run labels a scan as
    ``segment_cloud`` does at the same capacity.
    """
    cap = config.padded_count(n)
    octave = 1 << max(cap.bit_length() - 1, 3)
    for num in range(8, 17):
        bucket = octave // 8 * num
        if bucket >= cap:
            break
    # re-align to the capacity multiple (octave//8 below pad_to_multiple)
    bucket = config.padded_count(bucket)
    return max(bucket, config.pad_to_multiple)


def segment_files(
    input_paths,
    output_paths,
    config: PipelineConfig = DEFAULT_CONFIG,
    *,
    device="cuda",
    signed_normals: bool = False,
    render_dir: Optional[str] = None,
) -> list:
    """Multi-scan pipeline (BASELINE config 5): segment each scan on
    ``device``, colorize, write the labeled PLYs and, with ``render_dir``,
    the three ortho PNGs of each scan into ``render_dir/<scan name>/``.

    Each scan is padded to its :func:`_bucket_capacity`.  Host work
    overlaps the device from both sides: a reader thread decodes and
    uploads up to two scans ahead, the main thread runs the device
    pipeline, and a writer thread queues scan i's raster, fetches its
    labels, colorizes, writes its PLY and encodes its PNGs while the main
    thread runs scan i+1.  All threads use the device's default stream.
    Returns one :class:`PipelineOutput` per scan, in input order, without
    its device tensors (``device_shifted``/``device_mask`` are None): the
    writer frees them once the scan is written.
    """
    input_paths = list(input_paths)
    output_paths = list(output_paths)
    if len(input_paths) != len(output_paths):
        raise ValueError(f"{len(input_paths)} inputs but "
                         f"{len(output_paths)} outputs")
    dev = torch.device(device)

    def load_scan(path):
        """Reader thread: decode, dedup, bucket, upload, prove the hints.
        ``_upload`` synchronizes, so the batch is on the device before
        the main thread reads it."""
        t0 = time.perf_counter()
        cloud = read_ply(path, position_scale=config.position_scale)
        cloud = _maybe_dedup(cloud, config)
        cfg = dataclasses.replace(
            config, pad_to_multiple=_bucket_capacity(cloud.count, config))
        batch, shifted_h, lo_h, cfg = _upload(cloud, cfg, dev)
        return cloud, cfg, batch, shifted_h, lo_h, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as rpool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as wpool:
        pending = [rpool.submit(load_scan, p) for p in input_paths[:2]]
        writes = []
        for i, (in_path, out_path) in enumerate(zip(input_paths,
                                                    output_paths)):
            cloud, cfg, batch, shifted_h, lo_h, t_load = pending[i].result()
            pending[i] = None  # the batch lives only as long as its scan
            if i + 2 < len(input_paths):
                pending.append(rpool.submit(load_scan, input_paths[i + 2]))
            t0 = time.perf_counter()
            timings = {"host_to_device": t_load}
            shifted, seg = _run_device(batch, cfg, signed_normals, timings)
            timings["device_pipeline"] = time.perf_counter() - t0
            writes.append(wpool.submit(
                _write_scan, cloud, shifted_h, lo_h, shifted, batch.mask,
                seg, cfg, timings, t0, in_path, out_path, render_dir,
            ))
        return [w.result() for w in writes]


def _write_scan(cloud, shifted_h, lo_h, shifted, mask, seg, cfg, timings,
                t0, in_path, out_path, render_dir) -> PipelineOutput:
    """Writer thread: queue the raster (it reuses the positions on the
    device), fetch and colorize, write the labeled PLY, then fetch the
    rasters and write the PNGs.  ``cfg`` is the scan's configuration (the
    caller's, with the scan's capacity and hints)."""
    rasters = None
    if render_dir is not None:
        t = time.perf_counter()
        rasters = dispatch_ortho(shifted_h, shifted, mask, cfg)
        t_render = time.perf_counter() - t
    out = _finish_output(cloud, shifted_h, lo_h, shifted, mask, seg, cfg,
                         timings, t0)
    t = time.perf_counter()
    write_ply(out.cloud, out_path, position_scale=cfg.output_scale,
              ascii=not cfg.output_binary)
    out.timings["write_ply"] = time.perf_counter() - t
    if rasters is not None:
        t = time.perf_counter()
        base = os.path.splitext(os.path.basename(in_path))[0]
        finish_ortho(rasters, os.path.join(render_dir, base))
        out.timings["render"] = t_render + time.perf_counter() - t
    # the raster was their last reader: a batch of thousands of scans
    # would otherwise hold every scan's positions on the device (~15 MB a
    # 1M-point scan) until it ends
    out.device_shifted = out.device_mask = None
    return out
