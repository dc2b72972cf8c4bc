"""Fused window sweep: kNN distances + normal moments in one pass.

Port of ``buildingsegment_tpu/ops/fused.py``.  Per sorted point the ±W
Morton-window candidates give one distance row (ranked for the kNN lists
and the Open3D-hybrid cap) and the radius-masked first/second moments
of the covariance normal.  This stage has no Pallas kernel in the JAX
package; here it is plain PyTorch.

Exactness notes (held by tests/test_torch_fused.py):
  * ``lax.top_k`` breaks ties by the lower candidate slot; the port
    ranks with a STABLE ascending sort over the 2W slots in JAX's slot
    order (offsets −W…−1, then +1…+W), which breaks ties the same way;
  * squared distances are ``dx*dx + dy*dy + dz*dz`` in JAX's order and
    the moments accumulate slot by slot in slot order, as JAX's unrolled
    loop does.

Sharded (``group``, the JAX package's ``axis_name``): the window
padding is the ring neighbours' rows (:meth:`ShardGroup.halo_pad`,
−3e7 / False past the global edges) and neighbour indices come back in
the global sorted frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from buildingsegment_tpu_torch.ops.normals import eigh3x3_smallest

__all__ = [
    "knn_normals_window_sorted", "window_moments", "window_neighbors",
    "finish_normals",
]

_PAD = -3e7
# rows per tile: bounds the [T, 2W] candidate blocks (every result is
# per row, so the tiling does not change any value)
_TILE_ROWS = 1 << 18


def finish_normals(s0, s1, s2, *, orient_z: bool = True):
    """Moment sums → (unit normals f32[N, 3], curvature f32[N]).

    s0 f32[N] count (incl. self), s1 f32[N, 3] offset sum, s2 f32[N, 6]
    second moments (xx, yy, zz, xy, xz, yz) about the point.
    """
    safe = torch.clamp_min(s0, 1.0)
    mean = s1 / safe[:, None]
    m = s2 / safe[:, None]
    c00 = m[:, 0] - mean[:, 0] * mean[:, 0]
    c11 = m[:, 1] - mean[:, 1] * mean[:, 1]
    c22 = m[:, 2] - mean[:, 2] * mean[:, 2]
    c01 = m[:, 3] - mean[:, 0] * mean[:, 1]
    c02 = m[:, 4] - mean[:, 0] * mean[:, 2]
    c12 = m[:, 5] - mean[:, 1] * mean[:, 2]
    cov = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c01, c11, c12], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        dim=-2,
    )
    v, eigvals = eigh3x3_smallest(cov)
    z = torch.zeros_like(v)
    z[:, 2] = 1.0
    v = torch.where((s0 < 3.0)[:, None], z, v)
    if orient_z:
        v = torch.where((v[:, 2] < 0.0)[:, None], -v, v)
    total = eigvals[:, 0] + eigvals[:, 1] + eigvals[:, 2]
    curvature = torch.where(
        total > 0, eigvals[:, 0] / torch.where(total > 0, total, 1.0), 0.0
    )
    curvature = torch.where(s0 < 3.0, 0.0, curvature)
    return v, curvature


def _windows(a: torch.Tensor, window: int, r0: int, r1: int) -> torch.Tensor:
    """[r1 − r0, 2W] candidates of padded 1-D ``a`` for rows [r0, r1),
    columns in JAX's slot order (offsets −W…−1, +1…+W)."""
    win = a.unfold(0, 2 * window + 1, 1)[r0:r1]
    return torch.cat([win[:, :window], win[:, window + 1:]], dim=1)


def window_moments(
    spos: torch.Tensor,
    smask: torch.Tensor,
    *,
    window: int,
    radius: float,
    max_nn: Optional[int],
    keep: int,
    group=None,
):
    """The fused sweep's ranked distances and moments (``group``: this
    rank's rows, the neighbours' rows as window padding).

    Returns (the ``keep`` smallest squared candidate distances per row,
    ascending, +inf where fewer candidates are valid, f32[N, keep]; their
    slots in JAX's slot order, int64[N, keep]; s0 f32[N]; s1 f32[N, 3];
    s2 f32[N, 6]) — the moment sums of :func:`finish_normals`.
    """
    n = spos.shape[0]
    w2 = 2 * window
    dev = spos.device
    if group is None:
        fill = torch.full((window,), _PAD, dtype=torch.float32, device=dev)
        comps = [torch.cat([fill, spos[:, d].float(), fill])
                 for d in range(3)]
        off = torch.zeros(window, dtype=torch.bool, device=dev)
        pmask = torch.cat([off, smask, off])
    else:
        ppos = group.halo_pad(spos.float(), window, fill=_PAD)
        comps = [ppos[:, d].contiguous() for d in range(3)]
        pmask = group.halo_pad(smask, window, fill=False)
    r2 = float(np.float32(radius) * np.float32(radius))
    cap_active = max_nn is not None and (max_nn - 1) < w2

    nb_d = torch.empty((n, keep), dtype=torch.float32, device=dev)
    arg = torch.empty((n, keep), dtype=torch.int64, device=dev)
    s0 = torch.empty(n, dtype=torch.float32, device=dev)
    s1 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    s2 = torch.empty((n, 6), dtype=torch.float32, device=dev)
    for r0 in range(0, n, _TILE_ROWS):
        r1 = min(n, r0 + _TILE_ROWS)
        tsmask = smask[r0:r1]
        cmask = _windows(pmask, window, r0, r1) & tsmask[:, None]
        # offsets candidate − point, per axis [T, 2W]
        diff = [
            _windows(c, window, r0, r1) - spos[r0:r1, d].float()[:, None]
            for d, c in enumerate(comps)
        ]
        dx, dy, dz = diff
        d = dx * dx + dy * dy + dz * dz
        d = torch.where(cmask, d, torch.inf)
        srt, sarg = torch.sort(d, dim=1, stable=True)
        nb_d[r0:r1] = srt[:, :keep]
        arg[r0:r1] = sarg[:, :keep]
        if cap_active:
            # the (max_nn−1)-th nearest other (inf when fewer exist)
            r_eff2 = torch.clamp_max(srt[:, max_nn - 2], r2)
            use = cmask & (d <= r_eff2[:, None])
        else:
            use = cmask & (d <= r2)
        uw = use.float()
        a0 = tsmask.float()
        ax = torch.zeros_like(a0)
        ay, az = torch.zeros_like(a0), torch.zeros_like(a0)
        axx, ayy, azz = (torch.zeros_like(a0) for _ in range(3))
        axy, axz, ayz = (torch.zeros_like(a0) for _ in range(3))
        # slot-ordered accumulation, as JAX's unrolled loop
        for j in range(w2):
            u = uw[:, j]
            x, y, z = dx[:, j], dy[:, j], dz[:, j]
            a0 = a0 + u
            ax = ax + x * u
            ay = ay + y * u
            az = az + z * u
            axx = axx + x * x * u
            ayy = ayy + y * y * u
            azz = azz + z * z * u
            axy = axy + x * y * u
            axz = axz + x * z * u
            ayz = ayz + y * z * u
        s0[r0:r1] = a0
        s1[r0:r1] = torch.stack([ax, ay, az], dim=1)
        s2[r0:r1] = torch.stack([axx, ayy, azz, axy, axz, ayz], dim=1)
    return nb_d, arg, s0, s1, s2


def knn_normals_window_sorted(
    spos: torch.Tensor,
    smask: torch.Tensor,
    k: int,
    *,
    window: int = 64,
    radius: float = 100.0,
    orient_z: bool = True,
    max_nn: Optional[int] = None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused sweep → (neigh_idx int32[N, k], neigh_sq_dist f32[N, k],
    normals f32[N, 3], curvature f32[N]).

    Args:
        spos: float32[N, 3] Morton-sorted positions.
        smask: bool[N].
        k: neighbors INCLUDING self at slot 0 (2·window ≥ k−1).
        window: half-width of the candidate window.
        radius: normal-estimation neighborhood radius.
        max_nn: Open3D-hybrid cap (tmc3/my_function.h:63): the moments
            use the ``max_nn`` nearest candidates (incl. self) within
            ``radius``.  None, or a cap wider than the window, keeps
            every in-radius candidate.
        group: a ``dist.ShardGroup``: ``spos``/``smask`` are this rank's
            rows of the globally sorted cloud, the window reads the
            neighbours' rows, and ``neigh_idx`` holds global sorted rows.
    """
    if 2 * window < k - 1:
        raise ValueError(f"window {window} too small for k={k}")
    nb_d, arg, s0, s1, s2 = window_moments(
        spos, smask, window=window, radius=radius, max_nn=max_nn, keep=k - 1,
        group=group,
    )
    row_base = 0 if group is None else group.rank * spos.shape[0]
    nb_i, nb_d = window_neighbors(nb_d, arg, smask, window, row_base)
    v, curvature = finish_normals(s0, s1, s2, orient_z=orient_z)
    return nb_i, nb_d, v, curvature


def window_neighbors(nb_d, arg, smask, window: int, row_base: int = 0):
    """kNN finish of a window ranking: slot → row offset, self at slot 0,
    empty (+inf) slots and masked rows → self with distance 0; rows are
    numbered from ``row_base`` (a shard's first global row).

    Returns (neigh_idx int32[N, k], neigh_sq_dist f32[N, k]) for the
    ascending distances ``nb_d`` f32[N, k−1] and their slots ``arg``.
    """
    n = nb_d.shape[0]
    dev = nb_d.device
    offs = torch.where(arg < window, arg - window, arg - window + 1)
    rows = torch.arange(row_base, row_base + n, dtype=torch.int64,
                        device=dev)[:, None]
    nb_i = rows + offs
    invalid = torch.isinf(nb_d)
    nb_i = torch.where(invalid, rows, nb_i)
    nb_d = torch.where(invalid, 0.0, nb_d)
    nb_i = torch.cat([rows, nb_i], dim=1)
    nb_d = torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=dev), nb_d], 1)
    nb_i = torch.where(smask[:, None], nb_i, rows).to(torch.int32)
    nb_d = torch.where(smask[:, None], nb_d, 0.0)
    return nb_i, nb_d
