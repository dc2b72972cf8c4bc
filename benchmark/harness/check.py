"""What decides ``correct``: the port's outputs of sampled scans held
against the plain reference's, number by number, each against the limit
its cell's workload file fixes; and the check that nothing of JAX or the
JAX package was loaded.

The numbers (each a worst case over the sampled scans; 0 where the two
agree bit for bit).  Stage 1's come from the module of the kNN path the
configuration states (``benchmark/paths/<knn_method>.py``); the window
path's are :func:`compare_stage1`:

* ``sort_mismatch`` — share of points whose Morton-sorted position
  differs (stage 1's rows are compared in that order);
* ``kth_dist_gap`` — largest |d_k − d_k,ref| / max(d_k,ref, 1 mm²) of the
  squared k-th-neighbour distance over valid rows;
* ``normal_gap`` — largest 1 − |n · n_ref| of the point normals, and
  ``normal_gap_determined`` the same over the points whose normal the
  reference's eigenvalues determine: (λ1 − λ0) ≥ ``EIGEN_GAP`` · Σλ;
* ``curvature_gap`` — largest |c − c_ref| of the surface variation;
* ``label_mismatch`` — share of points whose plane label differs;
* ``plane_count_gap`` — |P − P_ref|;
* ``plane_size_gap`` — largest |count − count_ref| / count_ref, and
  ``plane_normal_gap`` (1 − |n · n_ref|) and ``plane_centre_gap_mm``
  (‖c − c_ref‖), over the planes both tables hold, by plane id;
* ``ply_mismatch`` — share of input points whose row in the written PLY
  (position and colour, in input order) is missing or differs;
* ``raster_gap`` — largest |pixel − pixel_ref| of the three PNGs, and
  ``raster_mismatch`` — the share of their pixels that differ (255 and 1
  where an image is missing or of another size).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np

#: modules whose presence in ``sys.modules`` fails a run, by top-level
#: name compared whole (``buildingsegment_tpu_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "buildingsegment_tpu")

#: the share of the eigenvalues' sum by which λ1 has to exceed λ0 for a
#: point's normal to count as determined
EIGEN_GAP = 0.01


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class ScanOut:
    """What the timed path produced for one scan (or what the control
    puts in its place)."""

    labels: np.ndarray                  # int32[n], input order
    num_planes: int
    plane_normals: np.ndarray
    plane_centers: np.ndarray
    plane_counts: np.ndarray
    stage1: Optional[dict] = None       # as :class:`RefScan.stage1`
    ply: Optional[dict] = None          # {"positions", "colors"} read back
    rasters: Optional[dict] = None      # {file name: uint8[H, W, 3]}


def _share(bad: np.ndarray, n: int) -> float:
    return float(np.count_nonzero(bad)) / max(n, 1)


def _cos_gap(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    cos = np.abs(np.sum(a.astype(np.float64) * b.astype(np.float64), 1))
    return float(np.max(1.0 - np.minimum(cos, 1.0)))


def _max(x: np.ndarray) -> float:
    return float(np.max(x)) if x.size else 0.0


def compare_stage1(got: dict, ref: dict, n: int) -> Dict[str, float]:
    """The window path's stage 1 in the Morton order; the n valid rows
    sort first, and only they are compared."""
    same = np.all(got["spos"][:n] == ref["spos"][:n], axis=1)
    dk = got["kth_sq_dist"][:n].astype(np.float64)
    dk_ref = ref["kth_sq_dist"][:n].astype(np.float64)
    determined = ref["eigen_gap"][:n] >= EIGEN_GAP
    return {
        "sort_mismatch": _share(~same, n),
        "kth_dist_gap": _max(np.abs(dk - dk_ref)
                             / np.maximum(np.abs(dk_ref), 1.0)),
        "normal_gap": _cos_gap(got["normals"][:n], ref["normals"][:n]),
        "normal_gap_determined": _cos_gap(got["normals"][:n][determined],
                                          ref["normals"][:n][determined]),
        "curvature_gap": _max(np.abs(
            got["curvature"][:n].astype(np.float64)
            - ref["curvature"][:n].astype(np.float64))),
    }


def compare_planes(got: ScanOut, ref) -> Dict[str, float]:
    """The labels and the plane table."""
    n = ref.labels.shape[0]
    m = min(got.num_planes, ref.num_planes)
    cr = ref.plane_counts[:m].astype(np.float64)
    return {
        "label_mismatch": _share(got.labels[:n] != ref.labels, n),
        "plane_count_gap": float(abs(got.num_planes - ref.num_planes)),
        "plane_size_gap": _max(np.abs(got.plane_counts[:m] - cr)
                               / np.maximum(cr, 1.0)),
        "plane_normal_gap": _cos_gap(got.plane_normals[:m],
                                     ref.plane_normals[:m]),
        "plane_centre_gap_mm": _max(np.linalg.norm(
            got.plane_centers[:m].astype(np.float64)
            - ref.plane_centers[:m].astype(np.float64), axis=1)),
    }


def compare_ply(ply: Optional[dict], ref) -> float:
    """``ply_mismatch``: rows of the written PLY against the reference's
    shifted positions and colours, in input order."""
    n = ref.labels.shape[0]
    if ply is None:
        return 1.0
    pos, col = ply["positions"], ply["colors"]
    k = min(pos.shape[0], n)
    ok = (np.all(pos[:k] == ref.shifted[:k], axis=1)
          & np.all(col[:k] == ref.colors[:k], axis=1))
    return (float(np.count_nonzero(~ok)) + (n - k)) / max(n, 1)


def compare_rasters(got: Optional[dict], ref: dict) -> Dict[str, float]:
    """``raster_gap``, the largest pixel difference of the three PNGs, and
    ``raster_mismatch``, the share of their pixels that differ (an image
    missing or of another size: 255 and 1)."""
    gap, bad, total = 0.0, 0, 0
    for name, img in ref.items():
        g = None if got is None else got.get(name)
        if g is None or g.shape != img.shape:
            return {"raster_gap": 255.0, "raster_mismatch": 1.0}
        diff = np.abs(g.astype(np.int32) - img.astype(np.int32))
        gap = max(gap, _max(diff))
        bad += int(np.count_nonzero(np.any(diff != 0, axis=-1)))
        total += img.shape[0] * img.shape[1]
    return {"raster_gap": gap, "raster_mismatch": bad / max(total, 1)}


def compare_scan(got: ScanOut, ref, path, *, ply: bool = True,
                 rasters: Optional[dict] = None) -> Dict[str, float]:
    """Every number of one scan (see the module's docstring); ``path`` is
    the module of the configuration's kNN path, which compares stage 1."""
    nums = {}
    if got.stage1 is not None:
        nums.update(path.compare_stage1(got.stage1, ref.stage1,
                                        ref.labels.shape[0]))
    nums.update(compare_planes(got, ref))
    if ply:
        nums["ply_mismatch"] = compare_ply(got.ply, ref)
    if rasters is not None:
        nums.update(compare_rasters(got.rasters, rasters))
    return nums


def worst(per_scan: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst case over the scans."""
    out: Dict[str, float] = {}
    for nums in per_scan:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(every number the cell limits is within its limit, {name: {"value",
    "limit"}}).  The cell's limits name the numbers it compares; a limit
    with no number (or a number that is not finite) fails."""
    checks, ok = {}, True
    for name in sorted(limits):
        value = numbers.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        checks[name] = {"value": value, "limit": limits[name]}
        if value is None or not value <= limits[name]:
            ok = False
    return ok, checks
