# Frozen copy of buildingsegment_tpu_torch/ops/stats_sweep.py at commit e8749d5,
# with every hand-written kernel call taken out: each call site runs
# the plain PyTorch version the port holds its kernel to.
"""Stats sweep: the k-th-NN squared distance and the normal moments.

Port of ``knn_normals_window_stats`` / ``fused_stats_sweep`` (kernel
``_stats_kernel``) in ``buildingsegment_tpu/ops/stats_sweep.py``.  The
multigrid solver consumes only two order statistics of each row's ±W
candidate distances — the squared k-th-NN distance (the seed ball) and
the ``max_nn``-th (the hybrid cap of the normal neighbourhood) — never
the sorted neighbour lists.  The kernel (``csrc/stats_sweep.cu``)
selects them exactly by merging sorted chunks of 16 candidates in
registers (``csrc/select_rank.cuh``); the plain
version takes them from the fused sweep's stable sort
(:func:`benchmark.reference.plain.ops.fused.window_moments`).  Order
statistics are values, so both give the same bits; the moments
accumulate in slot order in both, so they agree bit for bit too.

Sharded (``group``): the sweep runs on the shard's rows with the ring
neighbours' rows as halos (the JAX package's ``axis_name``), see
:func:`knn_normals_window_stats`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.plain import kernels
from benchmark.reference.plain.ops.fused import finish_normals, window_moments
from benchmark.reference.plain.ops.stats_mxu import mxu_halo, stats_mxu
from benchmark.reference.plain.ops.window_sweep import POS_FILL

__all__ = [
    "stats_sweep", "stats_sweep_reference", "knn_normals_window_stats",
    "RANK_MODES",
]

#: ``stats_rank_mode`` values: None, "bitonic" and "bisect" are the
#: exact sweep (the JAX package's two rankings give the same bits),
#: "mxu" the block-form variant
RANK_MODES = (None, "bitonic", "bisect", "mxu")


def stats_sweep_reference(
    pos, mask, *, k, w, radius, max_nn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`stats_sweep`: the fused sweep's
    ``neigh_sq_dist[:, k−1]`` plus its moments."""
    spos = torch.stack(list(pos), 1)
    nb_d, _arg, s0, s1, s2 = window_moments(
        spos, mask, window=w, radius=radius, max_nn=max_nn,
        keep=max(k - 1, 1),
    )
    if k < 2:
        dk = torch.zeros_like(s0)
    else:
        dk = nb_d[:, k - 2]
        dk = torch.where(torch.isinf(dk) | ~mask, 0.0, dk)
    return dk, s0, s1, s2


def stats_sweep(pos, mask, *, k, w, radius, max_nn, group=None):
    """One stats sweep → (kth_sq_dist f32[n], s0 f32[n], s1 f32[n, 3],
    s2 f32[n, 6]).

    ``pos`` is an (x, y, z) triple of f32[n] Morton-sorted positions,
    ``mask`` bool[n].  ``kth_sq_dist`` is the squared distance of the
    (k−1)-th nearest valid window candidate (0 where fewer exist or the
    row is masked); the moments (count incl. self, offset sums, second
    moments xx yy zz xy xz yz about the row) run over the candidates
    within ``radius`` and, when ``max_nn − 1 < 2w``, no farther than the
    (max_nn−1)-th nearest.  With ``group`` the columns hold w halo rows
    a side (position −3e7, mask False past the global edges) and the S
    middle rows come back.  CUDA tensors launch the CUDA kernel, CPU
    tensors run :func:`stats_sweep_reference`.
    """
    kw = dict(k=k, w=w, radius=radius, max_nn=max_nn)
    out = stats_sweep_reference(pos, mask, **kw)
    if group is None:
        return out
    n = mask.shape[0] - 2 * w
    return tuple(o[w:w + n] for o in out)


def knn_normals_window_stats(
    spos: torch.Tensor,
    smask: torch.Tensor,
    k: int,
    *,
    window: int = 64,
    radius: float = 100.0,
    orient_z: bool = True,
    max_nn=None,
    rank_mode=None,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stats-only sweep → (kth_sq_dist f32[N], normals f32[N, 3],
    curvature f32[N]); ``kth_sq_dist`` equals the fused sweep's
    ``neigh_sq_dist[:, k−1]`` and the normals/curvature its outputs.
    ``rank_mode`` is one of :data:`RANK_MODES`; "mxu" runs the
    block-form variant (the config's ``stats_rank_mode``).  With
    ``group`` (a ``dist.ShardGroup``) ``spos``/``smask`` are this rank's
    rows of the globally sorted cloud; the sweep reads the neighbours'
    rows through a ring halo and gives the one-device result of these
    rows."""
    if rank_mode not in RANK_MODES:
        raise ValueError(f"rank_mode={rank_mode!r}, expected one of "
                         f"{RANK_MODES}")
    sweep = stats_mxu if rank_mode == "mxu" else stats_sweep
    spos = spos.float()
    if group is not None:
        h = mxu_halo(window) if rank_mode == "mxu" else window
        spos = group.halo_pad(spos, h, fill=POS_FILL)
        smask = group.halo_pad(smask, h, fill=False)
    pos = tuple(spos[:, d].contiguous() for d in range(3))
    shard = {} if group is None else {"group": group}
    dk, s0, s1, s2 = sweep(
        pos, smask, k=k, w=window, radius=radius, max_nn=max_nn, **shard
    )
    normals, curvature = finish_normals(s0, s1, s2, orient_z=orient_z)
    return dk, normals, curvature
