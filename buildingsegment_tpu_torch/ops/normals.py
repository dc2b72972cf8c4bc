"""Closed-form 3×3 eigensolve and normal canonicalization.

Port of ``eigh3x3_smallest`` and ``canonicalize_normals`` from
``buildingsegment_tpu/ops/normals.py`` (the covariance-PCA normal of
Open3D's ``EstimateNormals``, tmc3/my_function.h:63-64).  Same formulas
in the same operation order; the trigonometric functions may differ
from XLA's by a few ulps.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["eigh3x3_smallest", "canonicalize_normals"]


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
