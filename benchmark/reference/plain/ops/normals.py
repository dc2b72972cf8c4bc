# Frozen copy of buildingsegment_tpu_torch/ops/normals.py at commit e8749d5,
# with every hand-written kernel call taken out: each call site runs
# the plain PyTorch version the port holds its kernel to.
"""Normals from a kNN graph, the closed-form 3×3 eigensolve and normal
canonicalization.

Port of ``estimate_normals``, ``estimate_normals_window``,
``eigh3x3_smallest`` and ``canonicalize_normals`` from
``buildingsegment_tpu/ops/normals.py`` (the covariance-PCA normal of
Open3D's ``EstimateNormals``, tmc3/my_function.h:63-64).  Same formulas
in the same operation order; the trigonometric functions may differ from
XLA's by a few ulps.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "estimate_normals",
    "estimate_normals_window",
    "eigh3x3_smallest",
    "canonicalize_normals",
]

_PAD = -3e7


def canonicalize_normals(normals: torch.Tensor) -> torch.Tensor:
    """Flip each normal so its largest-magnitude component (ties
    z > y > x) is non-negative — a hemisphere that does not depend on
    how the ±Z orientation of a wall normal landed."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    keyx = nx.abs()
    keyy = ny.abs() + 1e-7
    keyz = nz.abs() + 2e-7
    dom = torch.where(
        keyx >= torch.maximum(keyy, keyz),
        nx,
        torch.where(keyy >= keyz, ny, nz),
    )
    sign = torch.sign(dom)
    sign = torch.where(sign == 0, 1.0, sign)
    return normals * sign[..., None]


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def eigh3x3_smallest(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenvector + ascending eigenvalues of symmetric 3×3
    batches float32[..., 3, 3].

    Eigenvalues from the trigonometric solution of the characteristic
    cubic; the eigenvector is the largest cross product of rows of
    (A − λI).  Degenerate neighborhoods return v = (0, 0, 1).
    """
    a00 = cov[..., 0, 0]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a11 = cov[..., 1, 1]
    a12 = cov[..., 1, 2]
    a22 = cov[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    safe_p = torch.where(p > 0, p, 1.0)

    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detb / (2.0 * (safe_p * safe_p * safe_p)), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    eigvals = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)

    r0 = torch.stack([a00 - lam_lo, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam_lo, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam_lo], dim=-1)
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = _sum3(c01 * c01)
    n02 = _sum3(c02 * c02)
    n12 = _sum3(c12 * c12)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    best_norm = torch.sqrt(torch.clamp_min(_sum3(best * best), 0.0))

    scale = torch.clamp_min(q.abs(), 1.0)
    degenerate = (p <= 1e-7 * scale) | (best_norm <= 1e-12)
    z = torch.zeros_like(best)
    z[..., 2] = 1.0
    v = torch.where(
        degenerate[..., None],
        z,
        best / torch.where(degenerate, 1.0, best_norm)[..., None],
    )
    return v, eigvals


def estimate_normals(
    positions: torch.Tensor,
    mask: torch.Tensor,
    neigh_idx: torch.Tensor,
    neigh_sq_dist: torch.Tensor,
    *,
    radius: float = 100.0,
    max_nn: int = 50,
    orient_z: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit normals + curvature (λ0/Σλ) from a kNN graph: Open3D's hybrid
    neighbourhood, the ``max_nn`` nearest (self at slot 0) within
    ``radius``, gathered from ``neigh_idx`` int[N, K] and masked by
    ``neigh_sq_dist`` f32[N, K].  Rows with fewer than 3 usable
    neighbours get +Z; ``orient_z`` flips normals to n_z ≥ 0
    (tmc3/my_function.h:63-64).

    The second moments are written-out f32 products summed over the
    slots (JAX's HIGHEST einsum), so no TF32 setting touches them.
    """
    n, k = neigh_idx.shape
    pos = positions.float()
    idx = neigh_idx.long()
    r2 = float(np.float32(radius) * np.float32(radius))
    use = neigh_sq_dist <= r2
    if max_nn < k:
        use = use & (torch.arange(k, device=pos.device) < max_nn)
    use = use & mask[idx] & mask[:, None]
    w = use.float()
    cnt = w.sum(1)
    safe = torch.clamp_min(cnt, 1.0)
    # centered on the query point: keeps the moments small in f32
    nb = (pos[idx] - pos[:, None, :]) * w[:, :, None]
    mean = nb.sum(1) / safe[:, None]
    sec = (nb[:, :, :, None] * nb[:, :, None, :]).sum(1) / safe[:, None, None]
    cov = sec - mean[:, None, :] * mean[:, :, None]
    v, eigvals = eigh3x3_smallest(cov)
    z = torch.zeros_like(v)
    z[:, 2] = 1.0
    v = torch.where((cnt < 3.0)[:, None], z, v)
    if orient_z:
        v = torch.where((v[:, 2] < 0.0)[:, None], -v, v)
    total = eigvals[:, 0] + eigvals[:, 1] + eigvals[:, 2]
    curvature = torch.where(
        total > 0, eigvals[:, 0] / torch.where(total > 0, total, 1.0), 0.0
    )
    curvature = torch.where(cnt < 3.0, 0.0, curvature)
    return v, curvature


def estimate_normals_window(
    spos: torch.Tensor,
    smask: torch.Tensor,
    *,
    radius: float = 100.0,
    window: int = 64,
    orient_z: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals + curvature from the moments of the ±``window`` Morton
    neighbours within ``radius`` (no kNN graph, no neighbour cap).

    The neighbourhood is "window ∩ radius ball" rather than Open3D's
    "50 nearest ∩ radius" (tmc3/my_function.h:63); on dense scans the
    radius decides both.  On a CUDA tensor the moments come from the
    stats sweep (#3, ``csrc/stats_sweep.cu``) in radius-only mode (k = 1:
    no order statistic; no cap), as the JAX package runs its Pallas
    kernel on the TPU; on a CPU tensor from JAX's XLA form, one pass per
    offset −W..W (self included) adding the in-ball terms.  The two sum
    in different orders, so they agree within f32 rounding.

    Args:
        spos: float32[N, 3] Morton-sorted positions.
        smask: bool[N].
        radius: neighbourhood radius (the positions' unit).

    Returns (normals float32[N, 3] unit, +Z oriented when ``orient_z``;
    curvature float32[N]).
    """
    from benchmark.reference.plain.ops.fused import finish_normals

    if smask.is_cuda:
        from benchmark.reference.plain.ops.stats_sweep import stats_sweep

        pos = tuple(spos[:, d].float().contiguous() for d in range(3))
        _dk, s0, s1, s2 = stats_sweep(pos, smask, k=1, w=window,
                                      radius=radius, max_nn=None)
        return finish_normals(s0, s1, s2, orient_z=orient_z)

    n = spos.shape[0]
    w = window
    dev = spos.device
    fill = torch.full((w, 3), _PAD, dtype=torch.float32, device=dev)
    base = spos.float()
    ppos = torch.cat([fill, base, fill])
    off = torch.zeros(w, dtype=torch.bool, device=dev)
    pmask = torch.cat([off, smask, off])
    r2 = float(np.float32(radius) * np.float32(radius))
    s0 = torch.zeros(n, dtype=torch.float32, device=dev)
    s1 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    s2 = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    for slot in range(2 * w + 1):
        d = ppos[slot:slot + n] - base  # centered on the query point
        dist2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        uw = (pmask[slot:slot + n] & smask & (dist2 <= r2)).float()
        s0 = s0 + uw
        s1 = s1 + d * uw[:, None]
        s2 = s2 + torch.stack([
            d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
            d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2],
        ], 1) * uw[:, None]
    return finish_normals(s0, s1, s2, orient_z=orient_z)
