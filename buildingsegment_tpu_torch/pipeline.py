"""End-to-end segmentation pipeline of the port.

Port of the window path of ``buildingsegment_tpu/pipeline.py`` — the
reference's ``main()`` (tmc3/TMC3.cpp:202-229):

    read PLY (×1000 → integer mm)          ply::read, TMC3.cpp:208
    → bbox shift to origin                 buildingSeg ctor, TMC3.cpp:55-79
    → Morton sort, window kNN + normals    get_Normal_and_K_neighbor, :215
    → region-growing plane segmentation    seg_plane::get_planes, :217
    → per-plane random colors              set_plane_color, :218
    → write labeled binary PLY             ply::write, :221

Host I/O at the edges (the JAX package's ``io`` and ``native`` modules,
which import no jax), PyTorch on an explicit device in the middle.  The
written cloud is the *shifted* one, as the reference's constructor
mutates the caller's cloud in place.

This slice covers ``knn_method="window"`` without the multigrid stats
stage; every other configuration raises ``NotImplementedError`` naming
its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from buildingsegment_tpu.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.core.morton import morton_sort, unsort_labels
from buildingsegment_tpu_torch.core.pointset import PointBatch
from buildingsegment_tpu_torch.core.quantize import (
    dedup_keep_mask,
    estimate_spacing_mm,
    shift_to_origin,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.seg.colorize import colorize_planes
from buildingsegment_tpu_torch.seg.region_grow import segment_planes
from buildingsegment_tpu_torch.utils.device import synchronize

__all__ = [
    "PipelineOutput",
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


def run_device_pipeline(
    positions: torch.Tensor,
    mask: torch.Tensor,
    *,
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
    seg_anchor_cos=None,
    seg_compact=None,
    morton_small: bool = False,
    spacing_hint_mm=None,
    timings: Optional[dict] = None,
):
    """The on-device part: shift → Morton sort → window kNN + normals →
    segmentation → unsort.

    Returns (shifted positions, bbox_min, SegmentationResult with
    ``plane_idx`` in input order).  ``timings``, when given, receives
    per-stage seconds (each stage ends in a device synchronize).
    """
    if knn_method != "window":
        raise NotImplementedError(
            f"knn_method={knn_method!r} is a later slice of the port "
            "(ROADMAP.md: 'classic small-cloud path' for brute, the exact "
            "brute kNN kernel #14 for pallas)"
        )
    if seg_group > 1 and positions.shape[0] % (seg_group ** seg_levels) == 0:
        raise NotImplementedError(
            "the multigrid solver (seg_group > 1 with the stats stage) is "
            "a later slice of the port (ROADMAP.md: production stage 1 "
            "and multigrid coarse.py)"
        )
    timings = {} if timings is None else timings
    dev = positions.device
    t0 = time.perf_counter()
    shifted, lo, _hi = shift_to_origin(positions, mask)
    spos, smask, order = morton_sort(shifted, mask, morton_small)
    neigh_idx, neigh_d, normals, curv = knn_normals_window_sorted(
        spos.float(), smask, k=max(knn_k, 16), window=knn_window_size,
        radius=normal_radius, max_nn=normal_max_nn,
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
        signed_normals=signed_normals,
    )
    if seg_anchor_cos is not None:
        seg_kwargs["th_anchor_cos"] = seg_anchor_cos
    seg = segment_planes(
        spos, normals, neigh_idx[:, :knn_k], smask,
        neigh_sq_dist=neigh_d[:, :knn_k], curvature=curv,
        compact=seg_compact, **seg_kwargs,
    )
    t2 = time.perf_counter()
    timings["segmentation"] = t2 - t1
    timings.update(seg.timings)
    plane_idx = unsort_labels(order, seg.plane_idx)
    synchronize(dev)
    timings["unsort"] = time.perf_counter() - t2
    return shifted, lo, dataclasses.replace(seg, plane_idx=plane_idx)


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
    batch, shifted_h, lo_h = _prepare_upload(cloud, config, dev)
    config = _prove_morton_small(config, shifted_h)
    config = _prove_spacing(config, shifted_h)
    synchronize(dev)
    t1 = time.perf_counter()
    timings["host_to_device"] = t1 - t0

    _shifted, _lo, seg = run_device_pipeline(
        batch.positions, batch.mask,
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
        seg_anchor_cos=config.seg_anchor_cos,
        seg_compact=config.seg_compact,
        morton_small=config.morton_small,
        spacing_hint_mm=config.spacing_hint_mm,
        timings=timings,
    )
    t2 = time.perf_counter()
    timings["device_pipeline"] = t2 - t1

    n = cloud.count
    num_planes = seg.num_planes
    plane_idx = seg.plane_idx[:n].cpu().numpy().astype(np.int32)
    p_count = seg.plane_count[:num_planes].cpu().numpy()
    p_normal = seg.plane_normal[:num_planes].cpu().numpy()
    p_center = seg.plane_center[:num_planes].cpu().numpy()
    diag = seg.diagnostics.cpu().numpy()
    t3 = time.perf_counter()
    timings["device_to_host"] = t3 - t2

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


def segment_files(*args, **kwargs):
    """Multi-scan pipeline with ortho rendering — not in this slice."""
    raise NotImplementedError(
        "multi-scan segment_files and the ortho render are later slices "
        "of the port (ROADMAP.md: 'raster with #8', 'bench and profiling')"
    )
