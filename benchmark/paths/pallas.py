"""The exact-kNN path on kernel #14 (``knn_method="pallas"``): each
point's exact k_search-wide neighbour list, Open3D's hybrid normals over
it, and the graph solve, all in the input order.

* :func:`capture` keeps, for each scan run inside it, the lists
  ``pipeline.estimate_normals`` was given (after #14 and the scatter
  back to the input order) and the normals and curvature it gave, with
  the number of ``pipeline.knn_pallas`` calls that made them and the
  scan's ``PipelineOutput.diagnostics``;
* :func:`reference` is the plain reference of a scan: its stage 1 from
  :mod:`benchmark.reference.exact_stage1` (float64, written from the
  definition), its labels, plane table and colours from the frozen
  copy's hybrid normals and graph solve (``plain/``) run on the
  reference's own lists;
* :func:`compare_stage1` gives ``neighbour_mismatch``, ``kth_dist_gap``,
  ``normal_gap_determined`` and ``curvature_gap``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from benchmark.harness.check import EIGEN_GAP, _cos_gap, _max, _share
from benchmark.harness.wraps import patched
from benchmark.reference.exact_stage1 import exact_stage1
from benchmark.reference.plain.core.pointset import PAD_COORD
from benchmark.reference.plain.core.quantize import shift_to_origin
from benchmark.reference.plain.ops.normals import estimate_normals
from benchmark.reference.plain.seg.colorize import colorize_planes
from benchmark.reference.plain.seg.region_grow import segment_planes
from benchmark.reference.precision import tf32_products
from benchmark.reference.segment import RefScan, resolve_knn_method

__all__ = ["capture", "compare_stage1", "reference"]


def _host(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def capture(into: list):
    """Stage 1's outputs of the pipeline runs inside the block, one dict a
    scan appended to ``into`` in the order the scans run: ``neigh_idx``,
    ``neigh_sq_dist``, ``normals``, ``curvature`` (input order, padded
    rows included), ``knn_calls`` (the ``knn_pallas`` calls of the scan)
    and ``diagnostics``."""
    from buildingsegment_tpu_torch import pipeline

    calls = [0]

    def knn(orig):
        def wrap(*a, **kw):
            calls[0] += 1
            return orig(*a, **kw)
        return wrap

    def normals(orig):
        def wrap(positions, mask, neigh_idx, neigh_d, *a, **kw):
            nrm, curv = orig(positions, mask, neigh_idx, neigh_d, *a, **kw)
            into.append(dict(neigh_idx=_host(neigh_idx),
                             neigh_sq_dist=_host(neigh_d),
                             normals=_host(nrm), curvature=_host(curv),
                             knn_calls=calls[0]))
            calls[0] = 0
            return nrm, curv
        return wrap

    def scan(orig):
        def wrap(*a, **kw):
            out = orig(*a, **kw)
            if into:
                into[-1]["diagnostics"] = dict(out.diagnostics)
            return out
        return wrap

    with patched(pipeline, "knn_pallas", knn), \
            patched(pipeline, "estimate_normals", normals), \
            patched(pipeline, "segment_cloud", scan):
        yield into


def compare_stage1(got: dict, ref: dict, n: int) -> Dict[str, float]:
    """Stage 1 of the n input points, in the input order:

    * ``neighbour_mismatch`` — share of points whose list (indices, in
      order) differs; every point's where the lists did not come from one
      ``knn_pallas`` call;
    * ``kth_dist_gap`` — largest |d_k − d_k,ref| / max(d_k,ref, 1 mm²) of
      the lists' last (k-th) squared distance;
    * ``normal_gap_determined`` — largest 1 − |n · n_ref| over the points
      whose normal the reference's eigenvalues determine;
    * ``curvature_gap`` — largest |c − c_ref|.
    """
    same = np.all(got["neigh_idx"][:n] == ref["neigh_idx"][:n], axis=1)
    if got.get("knn_calls", 1) != 1:
        same[:] = False
    d = got["neigh_sq_dist"][:n, -1].astype(np.float64)
    d_ref = ref["neigh_sq_dist"][:n, -1]
    determined = ref["eigen_gap"][:n] >= EIGEN_GAP
    return {
        "neighbour_mismatch": _share(~same, n),
        "kth_dist_gap": _max(np.abs(d - d_ref) / np.maximum(d_ref, 1.0)),
        "normal_gap_determined": _cos_gap(got["normals"][:n][determined],
                                          ref["normals"][:n][determined]),
        "curvature_gap": _max(np.abs(
            got["curvature"][:n].astype(np.float64)
            - ref["curvature"][:n].astype(np.float64))),
    }


def reference(mm: np.ndarray, params: dict, *, capacity: int, device,
              tf32: bool = False) -> RefScan:
    """The reference's run on one scan (``mm`` int32[n, 3] as read, in
    integer mm; ``capacity`` the padded row count the run uses; ``tf32``
    runs it as the control): the host bbox shift, stage 1, then the
    pipeline's exact-kNN steps on the padded rows — the frozen hybrid
    normals from the reference's lists, the frozen graph solve over their
    first ``knn_k`` slots — and the colours."""
    with tf32_products() if tf32 else contextlib.nullcontext():
        return _reference(mm, params, capacity, device)


def _reference(mm, p, capacity, device) -> RefScan:
    if resolve_knn_method(p, capacity) != "pallas":
        raise ValueError("this reference runs the pallas path only")
    n = mm.shape[0]
    lo = mm.min(axis=0).astype(np.int32) if n else np.zeros(3, np.int32)
    shifted_h = (mm - lo[None, :]).astype(np.int32)
    k = max(p["knn_k_pad"], p["normal_max_nn"])
    stage1 = exact_stage1(shifted_h, k=k, radius=p["normal_radius"],
                          max_nn=p["normal_max_nn"],
                          orient_z=p["normal_orient_z"], device=device)
    dev = torch.device(device)
    pos = np.full((capacity, 3), PAD_COORD, np.int32)
    pos[:n] = shifted_h
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    with torch.no_grad():
        # padded rows list themselves at 0, as the port's do
        idx_t = torch.arange(capacity, dtype=torch.int32,
                             device=dev)[:, None].repeat(1, k)
        idx_t[:n] = torch.from_numpy(stage1["neigh_idx"]).to(dev)
        d2_t = torch.zeros((capacity, k), dtype=torch.float32, device=dev)
        d2_t[:n] = torch.from_numpy(stage1["neigh_sq_dist"]).to(dev).float()
        mask_t = torch.from_numpy(mask).to(dev)
        shifted, _lo, _hi = shift_to_origin(torch.from_numpy(pos).to(dev),
                                            mask_t)
        normals, curv = estimate_normals(
            shifted, mask_t, idx_t, d2_t,
            radius=p["normal_radius"], max_nn=p["normal_max_nn"])
        seg = segment_planes(
            shifted, normals, idx_t[:, :p["knn_k"]], mask_t, curvature=curv,
            th_seed_curvature=p["th_seed_curvature"],
            th_thickness=p["th_thickness"], th_normal_cos=p["th_normal_cos"],
            th_point_count=p["th_point_count"], max_planes=p["max_planes"],
            max_sweeps=p["max_sweeps"],
            convergence_tol=p["seg_convergence_tol"], signed_normals=False,
            propagation="graph")
        labels = seg.plane_idx[:n].cpu().numpy().astype(np.int32)
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
