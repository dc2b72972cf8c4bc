"""The plain reference of one scan: what the port computes from a scan's
points, worked out again in plain PyTorch from the same input.

Stage 1 (the Morton order, the k-th distances, normals and curvature)
comes from :mod:`benchmark.reference.stage1`, written from the
definition and sharing no code with the port.  The labels, the plane
table and the colours come from the frozen copy of the port's plain
paths (``plain/``, commit e8749d5, every hand-written kernel call
replaced by the plain version the port is held to), run on the device
it is given with the pipeline's own steps written out here: host bbox
shift, padded upload, the proven hints (one-key Morton sort, spacing
bucket), the window stats, the multigrid solve, the unsort and the
per-plane colours.  The solve's labels depend on the order of its
sums, which only the same algorithm keeps.  It imports nothing of the
port.

``tf32=True`` is the control: the same reference with TF32 products
(:mod:`benchmark.reference.precision`), on the exact coordinates.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.core.morton import morton_sort, unsort_labels
from benchmark.reference.plain.core.pointset import PAD_COORD
from benchmark.reference.plain.core.quantize import (
    estimate_spacing_mm,
    shift_to_origin,
    spacing_bucket_mm,
)
from benchmark.reference.plain.ops.stats_sweep import knn_normals_window_stats
from benchmark.reference.plain.seg.coarse import segment_planes_multigrid
from benchmark.reference.plain.seg.colorize import colorize_planes
from benchmark.reference.precision import tf32_products
from benchmark.reference.stage1 import window_stage1


@dataclasses.dataclass
class RefScan:
    """Host results of the reference on one scan (input order unless
    named otherwise)."""

    shifted: np.ndarray        # int32[n, 3] positions after the bbox shift
    labels: np.ndarray         # int32[n], 1..P or -1
    num_planes: int
    plane_normals: np.ndarray  # float32[P, 3]
    plane_centers: np.ndarray  # float32[P, 3]
    plane_counts: np.ndarray   # int32[P]
    colors: np.ndarray         # uint16[n, 3] (g, b, r)
    stage1: dict               # :func:`benchmark.reference.stage1.window_stage1`


def resolve_knn_method(params: dict, capacity: int) -> str:
    """'auto' → 'brute' at capacity ≤ knn_auto_threshold, else 'window'."""
    if params["knn_method"] != "auto":
        return params["knn_method"]
    return "brute" if capacity <= params["knn_auto_threshold"] else "window"


def segment_reference(mm: np.ndarray, params: dict, *, capacity: int,
                      device, tf32: bool = False) -> RefScan:
    """The reference's run on one scan.

    ``mm`` int32[n, 3] are the positions as read (integer mm); ``params``
    the pipeline fields of the configuration; ``capacity`` the padded row
    count the run uses.  ``tf32`` runs it as the control.
    """
    with tf32_products() if tf32 else contextlib.nullcontext():
        return _reference(mm, params, capacity, device)


def _reference(mm, p, capacity, device) -> RefScan:
    n = mm.shape[0]
    lo = mm.min(axis=0).astype(np.int32) if n else np.zeros(3, np.int32)
    shifted_h = (mm - lo[None, :]).astype(np.int32)
    if resolve_knn_method(p, capacity) != "window":
        raise ValueError("the reference runs the window path only")
    stage1 = window_stage1(shifted_h, k=p["knn_k"], window=p["knn_window"],
                           radius=p["normal_radius"],
                           max_nn=p["normal_max_nn"], device=device)
    pos = np.full((capacity, 3), PAD_COORD, np.int32)
    pos[:n] = shifted_h
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    dev = torch.device(device)
    positions = torch.from_numpy(pos).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    morton_small = bool(p["morton_small"])
    spacing = p["spacing_hint_mm"]
    if n:
        if not morton_small and int(shifted_h.max()) < (1 << 20):
            morton_small = True
        if spacing is None:
            spacing = spacing_bucket_mm(estimate_spacing_mm(shifted_h))
    with torch.no_grad():
        seg, order = _window(positions, mask_t, p, morton_small, spacing)
        labels = unsort_labels(order, seg.plane_idx)[:n].cpu().numpy()
        labels = labels.astype(np.int32)
        num_planes = int(seg.num_planes)
        return RefScan(
            shifted=shifted_h,
            labels=labels,
            num_planes=num_planes,
            plane_normals=seg.plane_normal[:num_planes].cpu().numpy(),
            plane_centers=seg.plane_center[:num_planes].cpu().numpy(),
            plane_counts=seg.plane_count[:num_planes].cpu().numpy(),
            colors=colorize_planes(labels, num_planes, low=p["color_low"],
                                   rng_range=p["color_range"]),
            stage1=stage1,
        )


def _seg_kwargs(p: dict, spacing) -> dict:
    edge0 = 2.0 * p["th_thickness"]
    if spacing is not None:
        edge0 = max(edge0, 3.0 * spacing)
    kw = dict(
        max_edge_dist=edge0, th_seed_curvature=p["th_seed_curvature"],
        th_thickness=p["th_thickness"], th_normal_cos=p["th_normal_cos"],
        th_point_count=p["th_point_count"], max_planes=p["max_planes"],
        max_sweeps=p["max_sweeps"],
        convergence_tol=p["seg_convergence_tol"], signed_normals=False,
    )
    if p["seg_anchor_cos"] is not None:
        kw["th_anchor_cos"] = p["seg_anchor_cos"]
    return kw


def _window(positions, mask, p, morton_small, spacing):
    """The window path: bbox shift, Morton sort, the stats sweep, the
    multigrid solve → (the solve's result, the Morton order)."""
    if not (p["seg_group"] > 1 and positions.shape[0]
            % (p["seg_group"] ** p["seg_levels"]) == 0):
        raise ValueError("the reference runs the multigrid solve only")
    shifted, _lo, _hi = shift_to_origin(positions, mask)
    spos, smask, order = morton_sort(shifted, mask, morton_small)
    kw = _seg_kwargs(p, spacing)
    kw["compact"] = p["seg_compact"]
    dk, normals, curv = knn_normals_window_stats(
        spos.float(), smask, k=p["knn_k"], window=p["knn_window"],
        radius=p["normal_radius"], max_nn=p["normal_max_nn"],
        rank_mode=p["stats_rank_mode"])
    seg = segment_planes_multigrid(
        spos, normals, smask, kth_sq_dist=dk, curvature=curv,
        group=p["seg_group"], levels=p["seg_levels"],
        refine_sweeps=p["seg_refine_sweeps"],
        seed_source=p["seg_seed_source"], seed_mode=p["seg_seed_mode"],
        spacing_hint_mm=spacing, **kw)
    return seg, order
