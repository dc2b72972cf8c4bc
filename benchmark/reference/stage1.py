"""Stage 1 of the window path, worked out from its definition and from
nothing of the port or of the frozen copy (``plain/``).

For the shifted points of one scan (integer mm, every coordinate below
2^20):

* the Morton order: the 60-bit key interleaving bit b of x, y and z at
  bits 3b, 3b + 1 and 3b + 2, sorted stably (ties keep the input order);
* for each point, its candidates: the points up to ``window`` rows
  before and after it in that order (itself left out);
* ``kth_sq_dist``: the squared distance of the (k − 1)-th nearest
  candidate (0 where fewer exist);
* the neighbourhood: the candidates within ``radius`` and no farther
  than the (max_nn − 1)-th nearest, and the point itself;
* the normal: the eigenvector of the neighbourhood's covariance with the
  smallest eigenvalue, from LAPACK's ``eigh`` (numpy), turned to z ≥ 0
  ((0, 0, 1) under three points); the curvature λ0 / (λ0 + λ1 + λ2)
  (0 where the sum is 0 or under three points); ``eigen_gap``
  (λ1 − λ0) / (λ0 + λ1 + λ2), how well the normal is determined (0
  under three points).

Distances and moments run in float64, exact for integer millimetres.
As the control (:func:`benchmark.reference.precision.tf32_products`)
the same steps run in float32 with TF32 products.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import precision
from benchmark.reference.precision import rp

#: bits a coordinate may hold
AXIS_BITS = 20


def morton_order(shifted: np.ndarray) -> np.ndarray:
    """Stable order int64[n] of the points by their Morton key."""
    if shifted.size and not (0 <= int(shifted.min())
                             and int(shifted.max()) < 1 << AXIS_BITS):
        raise ValueError("stage 1 takes shifted coordinates in [0, 2^20)")
    p = shifted.astype(np.uint64)
    key = np.zeros(p.shape[0], np.uint64)
    one = np.uint64(1)
    for b in range(AXIS_BITS):
        for axis in range(3):
            key |= ((p[:, axis] >> np.uint64(b)) & one) << np.uint64(
                3 * b + axis)
    return np.argsort(key, kind="stable")


def window_stage1(shifted: np.ndarray, *, k: int, window: int,
                  radius: float, max_nn, device,
                  rows_a_block: int = 1 << 15) -> dict:
    """Stage 1 of one scan, in the Morton order: ``spos`` int32[n, 3],
    ``kth_sq_dist`` [n], ``normals`` [n, 3], ``curvature`` [n],
    ``eigen_gap`` [n] (float64; float32 as the control)."""
    n = shifted.shape[0]
    order = morton_order(shifted)
    spos = np.ascontiguousarray(shifted[order]).astype(np.int32)
    dt = torch.float32 if precision.active() else torch.float64
    dev = torch.device(device)
    pos = torch.from_numpy(spos).to(dev).to(dt)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)])
    offs = offs.to(dev)
    r2 = float(radius) * float(radius)
    cap_rank = None
    if max_nn is not None and max_nn - 1 < 2 * window:
        cap_rank = max_nn - 2
    dks, s0s, covs = [], [], []
    for r0 in range(0, n, rows_a_block):
        rows = torch.arange(r0, min(n, r0 + rows_a_block), device=dev)
        cand = rows[:, None] + offs[None, :]
        valid = (cand >= 0) & (cand < n)
        off = rp(pos[cand.clamp(0, n - 1)] - pos[rows][:, None, :])
        d = (off * off).sum(-1)
        d = torch.where(valid, d, torch.inf)
        ranked = torch.sort(d, dim=1).values
        dk = ranked[:, k - 2] if k >= 2 else torch.zeros_like(d[:, 0])
        dks.append(torch.where(torch.isinf(dk), 0.0, dk).cpu())
        bound = torch.full_like(dk, r2)
        if cap_rank is not None:
            bound = torch.clamp(ranked[:, cap_rank], max=r2)
        u = (valid & (d <= bound[:, None])).to(dt)
        s0 = 1.0 + u.sum(1)
        s1 = (u[..., None] * off).sum(1)
        s2 = torch.einsum("rj,rja,rjb->rab", u, off, off)
        mean = rp(s1 / s0[:, None])
        cov = s2 / s0[:, None, None] - mean[:, :, None] * mean[:, None, :]
        s0s.append(s0.cpu())
        covs.append(cov.cpu())
    if not n:
        return {"spos": spos, "kth_sq_dist": np.zeros(0),
                "normals": np.zeros((0, 3)), "curvature": np.zeros(0),
                "eigen_gap": np.zeros(0)}
    # the eigen solve on the host (LAPACK), in the type of the moments
    evals, evecs = np.linalg.eigh(torch.cat(covs).numpy())
    s0 = torch.cat(s0s).numpy()
    few = s0 < 3.0
    v = np.where(few[:, None], np.array([0.0, 0.0, 1.0], evecs.dtype),
                 evecs[:, :, 0])
    v = np.where((v[:, 2] < 0.0)[:, None], -v, v)
    total = evals.sum(1)
    safe = np.where(total > 0, total, 1.0)
    curv = np.where(few | (total <= 0), 0.0, evals[:, 0] / safe)
    gap = np.where(few | (total <= 0), 0.0, (evals[:, 1] - evals[:, 0]) / safe)
    return {"spos": spos, "kth_sq_dist": torch.cat(dks).numpy(),
            "normals": v, "curvature": curv.astype(evals.dtype),
            "eigen_gap": gap}
