"""Golden oracle: faithful host model of the reference segmentation.

The port's copy of ``buildingsegment_tpu/seg/golden.py`` (plain numpy,
the same function bit for bit).

The reference binary is Windows-only and needs OpenCV + Open3D to build,
so behavioral parity is defined against this numpy re-implementation of
the exact semantics of ``seg_plane::{get_planes, Broad}``
(tmc3/my_function.cpp:180-258), including the documented quirks
(SURVEY.md §2.1.1):

  * scan points in index order; unlabeled (−1) points seed a candidate
    plane with model (normal_i, position_i) (my_function.cpp:184-191);
  * ``Broad`` examines neighbor slots 1..K−1 (slot 0 = self); accepts a
    neighbor iff its planeIdx ≤ 0, |(p − center)·n̄| ≤ 300 and
    n̄·n ≥ 0.88 (my_function.cpp:224-236);
  * depth-0 strictness: a seed fails unless ALL K−1 neighbors were
    accepted (my_function.cpp:238-239);
  * after each selection round the model is recomputed as the mean over
    ALL current members — normal sum normalized in double, center sum
    in **wrapping int32** divided by the (size_t) member count
    (my_function.cpp:241-250);
  * DFS recursion into each accepted neighbor in order
    (my_function.cpp:252-255) — here an explicit stack, preserving the
    exact call/mutation order;
  * quirk 1: the seed's own planeIdx is never set at seeding time (it
    can be re-accepted later, even by its own plane — duplicate entry in
    pointIdx);
  * quirk 2: when a depth-0 ``Broad`` fails, neighbors already stamped
    keep their labels (the leak at my_function.cpp:193-194);
  * planes are accepted iff pointIdx.size() > 400 (strict), else all
    members reset to −1 and the id is reused (my_function.cpp:199-209).

This is intentionally plain Python/numpy — it is an oracle, not a fast
path.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["golden_segment", "GoldenPlane"]

_I32_MIN = -(2**31)
_U32 = 2**32


def _wrap_i32(v: np.ndarray) -> np.ndarray:
    """Two's-complement int32 wraparound of an int64 value."""
    return ((v - _I32_MIN) % _U32) + _I32_MIN


def _div_sizet(v: int, n: int) -> int:
    """C++ ``int32 /= size_t``: int converts to uint64 first."""
    if v >= 0:
        return v // n
    return _wrap_i32(np.int64((v % 2**64) // n))


@dataclasses.dataclass
class GoldenPlane:
    id: int
    normal: np.ndarray  # float64[3]
    center: np.ndarray  # int32[3]
    point_idx: List[int]  # may contain duplicates (quirk 1)


def golden_segment(
    positions: np.ndarray,
    normals: np.ndarray,
    neigh: np.ndarray,
    *,
    k: int = 15,
    th_thickness: float = 300.0,
    th_point_count: int = 400,
    th_normal_cos: float = 0.88,
):
    """Run the reference's sequential region growing exactly.

    Args:
        positions: int32[N, 3] (bbox-shifted quantized coords).
        normals: float64[N, 3] unit normals.
        neigh: int32[N, K] with self at slot 0, K ≥ k.
        k: the reference's K (15).

    Returns:
        (plane_idx int32[N] with −1 unlabeled / leaked labels as the
         reference leaves them, planes list[GoldenPlane]).
    """
    n = positions.shape[0]
    pos = positions.astype(np.int64)
    nrm = normals.astype(np.float64)
    plane_idx = np.full(n, -1, np.int32)

    planes: List[GoldenPlane] = []
    cur_plane_id = 1

    for i in range(n):
        if plane_idx[i] != -1:
            continue

        cur_normal = nrm[i].copy()
        cur_center = pos[i].astype(np.int64)  # Vec3<int> semantics
        cur_points: List[int] = [i]
        # Running sums over members in append order.  The reference
        # recomputes these from scratch on every Broad call
        # (my_function.cpp:241-250) but always iterates pointIdx in
        # append order, so incremental accumulation is bit-identical
        # (float64 addition order preserved; int32 wrap is associative).
        sum_normal = nrm[i].copy()
        sum_center = pos[i].astype(np.int64)

        def select(idx_pt):
            """Selection half of Broad: neighbor slots 1..K−1."""
            nonlocal sum_normal, sum_center
            selected = []
            for s in range(1, k):
                j = int(neigh[idx_pt, s])
                if plane_idx[j] <= 0:
                    pv = _wrap_i32(pos[j] - cur_center)  # Vec3<int> subtraction
                    dist = abs(float(pv @ cur_normal))
                    if dist <= th_thickness and cur_normal @ nrm[j] >= th_normal_cos:
                        selected.append(j)
                        cur_points.append(j)
                        plane_idx[j] = cur_plane_id
                        sum_normal = sum_normal + nrm[j]
                        sum_center = _wrap_i32(sum_center + pos[j])
            return selected

        def recompute():
            nonlocal cur_normal, cur_center
            norm = np.sqrt(sum_normal @ sum_normal)
            cur_normal = sum_normal / norm  # may be NaN like the C++ (NDEBUG)
            m = len(cur_points)
            cur_center = np.array(
                [_div_sizet(int(c), m) for c in sum_center], np.int64
            )

        # --- Broad(i, 0) with explicit DFS stack ---
        sel0 = select(i)
        if len(sel0) < k - 1:
            # quirk 2: already-stamped neighbors keep cur_plane_id
            continue
        recompute()
        stack = [(sel0, 0)]
        while stack:
            sel, child = stack[-1]
            if child == len(sel):
                stack.pop()
                continue
            stack[-1] = (sel, child + 1)
            csel = select(sel[child])
            recompute()  # depth>0 Broad always recomputes, even if empty
            stack.append((csel, 0))

        if len(cur_points) > th_point_count:
            planes.append(
                GoldenPlane(
                    id=cur_plane_id,
                    normal=cur_normal.copy(),
                    center=cur_center.astype(np.int32).copy(),
                    point_idx=list(cur_points),
                )
            )
            cur_plane_id += 1
        else:
            for j in cur_points:
                plane_idx[j] = -1

    return plane_idx, planes
