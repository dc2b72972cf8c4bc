"""Block-form stats and seed sweeps: the ``"mxu"`` variants.

Port of ``fused_stats_mxu`` (kernel ``_stats_mxu_kernel``) and
``seed_sweep_mxu`` (kernel ``_seed_mxu_kernel``) in
``buildingsegment_tpu/ops/stats_mxu.py``, selected by
``PipelineConfig(stats_rank_mode="mxu")`` and ``seg_seed_mode="mxu"``.

They are not the exact sweeps (``ops/stats_sweep.py``,
``ops/window_sweep.seed_sweep``) in another layout: they compute another
rounding of the same geometry, and the port computes that rounding.

* Queries go in blocks of 128 rows: block b holds rows [128b, 128b+128)
  and its C = 128 + 2w candidates are rows [128b − w, 128b + 128 + w);
  outside [0, n) a candidate is the slab fill (position −3e7, normal 0,
  mask 0).
* Every block has its own origin o: per axis the least coordinate of
  its valid candidates, 0 when it has none.
* The squared distance of candidate c and query q is the TPU kernel's
  8-term matmul row, added left to right:
  D = (c−o)·(−2(q−o)) + |c−o|² + |q−o|² + BIG_c + BIG_q (+ 0·0), with
  BIG = 1e30 for an invalid candidate or query.  After the |c−o|² term
  no partial sum is −0, so the last term adds nothing and is left out.
* Stats: D is clamped at 0.  The ranks see D plus a static +BIG outside
  the ±w window and at self; ``dk`` is the (k−1)-th smallest, 0 when
  its bits are at or above 1e29's (a mask payload, not a distance).
  The hybrid cap is r_eff² = min(r², (max_nn−1)-th smallest) when
  max_nn − 1 < 2w.  The moments sum, in candidate order, the raw
  block-local terms [1, c−o, (c−o)ᵃ(c−o)ᵇ] of the candidates with
  D + (0 in the window, self included, else BIG) ≤ r_eff², and convert
  them to query-centred sums with the TPU kernel's expressions.
* Seeds: a valid query is bad when some candidate in its window (self
  excluded) with D ≤ dk fails |(c−o)·n_q − (q−o)·n_q| ≤ th or
  (|)n_c·n_q(|) ≥ cos; the dots of three terms are added left to right
  (the matmul's five zero products change only the sign of a zero,
  which no comparison sees).

The CUDA kernels (``csrc/stats_mxu.cu``) and the plain versions here
make the same f32 operations in the same order (the library is built
with ``-fmad=false``), so they agree bit for bit.  The plain versions
write the dots and candidate sums as explicit ordered elementwise
steps, never a matmul or a reduction of unfixed order, and walk the
blocks in chunks so that no [blocks, C, 128] tensor outgrows memory.
Against the JAX kernels: bit for bit while every intermediate is an
exact f32 integer (coordinates < 256); at building span within
``tests/test_stats_mxu.py``'s bounds (tests/test_torch_mxu.py).

Sharded (``group``): a block's result depends on where the block
starts, so the halo is :func:`mxu_halo` rows a side — w rounded up to a
whole block — and the shard a whole number of blocks: the padded rows'
blocks then are the one-device blocks, and the S middle rows come back
with the one-device bits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from buildingsegment_tpu_torch import kernels

__all__ = [
    "stats_mxu", "stats_mxu_reference", "seed_sweep_mxu",
    "seed_sweep_mxu_reference", "mxu_ranks", "mxu_r2", "mxu_halo",
]

#: query rows per block (the TPU kernel's 128 lanes)
MXU_BLOCK = 128
_BIG = 1e30
#: a rank value at or above this bit pattern (f32 1e29) is a mask
#: payload, not a distance
BIG_CUT_BITS = 0x6FA18F08
_POS_FILL = -3e7
_ORIGIN_FILL = 3e7
# block-chunk budget of the plain versions: elements of one [blocks, C,
# 128] tensor
_CHUNK_ELEMS = 1 << 25


def _blocks(n: int) -> int:
    return -(-n // MXU_BLOCK)


def mxu_halo(w: int) -> int:
    """Halo rows a side of a sharded block-form sweep: w rounded up to a
    whole block, so the shard's blocks keep their one-device starts."""
    return _blocks(w) * MXU_BLOCK


def _middle(group, w: int, rows: torch.Tensor, out):
    """The S middle rows of a sweep over :func:`mxu_halo` halo-padded
    rows (all rows without a group)."""
    if group is None:
        return out
    h = mxu_halo(w)
    n = rows.shape[0] - 2 * h
    if n <= 0 or n % MXU_BLOCK:
        raise ValueError(
            f"sharded block-form sweep: {rows.shape[0]} rows are not a "
            f"shard of whole {MXU_BLOCK}-row blocks with {h} halo rows a "
            "side")
    if isinstance(out, tuple):
        return tuple(o[h:h + n] for o in out)
    return out[h:h + n]


def _gather_blocks(rows: Sequence[torch.Tensor], fills, w: int,
                   b0: int, b1: int):
    """Each row's candidates of blocks [b0, b1) as [b1 − b0, C], the fill
    outside [0, n)."""
    n = rows[0].shape[0]
    dev = rows[0].device
    c = MXU_BLOCK + 2 * w
    idx = (torch.arange(b0, b1, device=dev)[:, None] * MXU_BLOCK - w
           + torch.arange(c, device=dev)[None, :])
    inside = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    return [torch.where(inside, r[idx], fill) for r, fill in zip(rows, fills)]


def _origin(cx, cy, cz, cv):
    """Per block the least coordinates of its valid candidates (0 where
    it has none), as [blocks, 1] columns."""
    anyv = cv.any(1, keepdim=True)
    return [torch.where(anyv, torch.where(cv, a, _ORIGIN_FILL)
                        .amin(1, keepdim=True), 0.0) for a in (cx, cy, cz)]


def _distance(cxo, cyo, czo, cv, qxo, qyo, qzo, qv):
    """[blocks, C, 128] D of the module docstring: the 8-term row added
    left to right."""
    c2 = cxo * cxo + cyo * cyo + czo * czo
    q2 = qxo * qxo + qyo * qyo + qzo * qzo
    bigc = torch.where(cv, 0.0, _BIG)
    bigq = torch.where(qv, 0.0, _BIG)
    d = cxo[:, :, None] * (-2.0 * qxo)[:, None, :]
    d = d + cyo[:, :, None] * (-2.0 * qyo)[:, None, :]
    d = d + czo[:, :, None] * (-2.0 * qzo)[:, None, :]
    d = d + c2[:, :, None]
    d = d + q2[:, None, :]
    d = d + bigc[:, :, None]
    return d + bigq[:, None, :]


def _window_offsets(w: int, dev) -> torch.Tensor:
    """[C, 128] offset c − w − q of candidate c from query q."""
    c = MXU_BLOCK + 2 * w
    return (torch.arange(c, device=dev)[:, None] - w
            - torch.arange(MXU_BLOCK, device=dev)[None, :])


def _chunk_blocks(w: int) -> int:
    return max(1, _CHUNK_ELEMS // ((MXU_BLOCK + 2 * w) * MXU_BLOCK))


def mxu_ranks(k: int, w: int, max_nn) -> Tuple[int, int]:
    """(rank of ``dk`` among the C candidates, rank of the hybrid cap or 0
    when the cap is wider than the window), 1-based; 0 = none."""
    cap_active = max_nn is not None and (max_nn - 1) < 2 * w
    return k - 1, (max_nn - 1) if cap_active else 0


def mxu_r2(radius) -> float:
    """The radius squared as the TPU wrapper takes it: in double, rounded
    once to f32."""
    return float(np.float32(float(radius) * float(radius)))


def stats_mxu_reference(
    pos, mask, *, k, w, radius, max_nn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`stats_mxu`."""
    n = mask.shape[0]
    dev = mask.device
    r_k, r_cap = mxu_ranks(k, w, max_nn)
    r2 = mxu_r2(radius)
    off = _window_offsets(w, dev)
    in_win = (off >= -w) & (off <= w)
    rank_add = torch.where(in_win & (off != 0), 0.0, _BIG)
    mom_add = torch.where(in_win, 0.0, _BIG)
    nb = _blocks(n)
    out = torch.empty((11, nb * MXU_BLOCK), dtype=torch.float32, device=dev)
    step = _chunk_blocks(w)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        cx, cy, cz, cv = _gather_blocks(
            [*pos, mask], [_POS_FILL] * 3 + [False], w, b0, b1)
        ox, oy, oz = _origin(cx, cy, cz, cv)
        cxo, cyo, czo = cx - ox, cy - oy, cz - oz
        q = slice(w, w + MXU_BLOCK)
        qxo, qyo, qzo, qv = cxo[:, q], cyo[:, q], czo[:, q], cv[:, q]
        d = torch.clamp_min(
            _distance(cxo, cyo, czo, cv, qxo, qyo, qzo, qv), 0.0)
        rank = d + rank_add
        if r_k:
            dk = torch.kthvalue(rank, r_k, dim=1).values
            dk = torch.where(dk.view(torch.int32) >= BIG_CUT_BITS, 0.0, dk)
        else:
            dk = torch.zeros_like(qxo)
        if r_cap:
            cap = torch.kthvalue(rank, r_cap, dim=1).values
            r_eff2 = torch.minimum(torch.full_like(cap, r2), cap)
        else:
            r_eff2 = torch.full_like(qxo, r2)
        gate = (d + mom_add) <= r_eff2[:, None, :]
        del d, rank
        # per candidate the raw terms 1, x, y, z, xx, yy, zz, xy, xz, yz
        terms = torch.stack(
            [torch.ones_like(cxo), cxo, cyo, czo, cxo * cxo, cyo * cyo,
             czo * czo, cxo * cyo, cxo * czo, cyo * czo], 1)
        m = torch.zeros((b1 - b0, 10, MXU_BLOCK), dtype=torch.float32,
                        device=dev)
        for c in range(cxo.shape[1]):  # candidate order
            m = torch.where(gate[:, c, None, :], m + terms[:, :, c, None], m)
        n_, sx, sy, sz = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
        sxx = m[:, 4] - 2.0 * qxo * sx + n_ * qxo * qxo
        syy = m[:, 5] - 2.0 * qyo * sy + n_ * qyo * qyo
        szz = m[:, 6] - 2.0 * qzo * sz + n_ * qzo * qzo
        sxy = m[:, 7] - qxo * sy - qyo * sx + n_ * qxo * qyo
        sxz = m[:, 8] - qxo * sz - qzo * sx + n_ * qxo * qzo
        syz = m[:, 9] - qyo * sz - qzo * sy + n_ * qyo * qzo
        rows = slice(b0 * MXU_BLOCK, b1 * MXU_BLOCK)
        for r, v in enumerate((dk, n_, sx - n_ * qxo, sy - n_ * qyo,
                               sz - n_ * qzo, sxx, syy, szz, sxy, sxz, syz)):
            out[r, rows] = v.reshape(-1)
    out = out[:, :n]
    return out[0], out[1], out[2:5].T, out[5:11].T


def stats_mxu(pos, mask, *, k, w, radius, max_nn, group=None):
    """Block-form stats sweep → (kth_sq_dist f32[n], s0 f32[n], s1 f32[n,
    3], s2 f32[n, 6]), the contract of
    :func:`buildingsegment_tpu_torch.ops.stats_sweep.stats_sweep` in the
    module docstring's rounding.  With ``group`` the columns hold
    :func:`mxu_halo` rows a side and the S middle rows come back.  CUDA
    tensors launch the CUDA kernel, CPU tensors run
    :func:`stats_mxu_reference`."""
    kw = dict(k=k, w=w, radius=radius, max_nn=max_nn)
    if mask.is_cuda:
        out = kernels.stats_mxu_cuda(pos, mask, **kw)
    else:
        out = stats_mxu_reference(pos, mask, **kw)
    return _middle(group, w, mask, out)


def seed_sweep_mxu_reference(
    pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos, signed=False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`seed_sweep_mxu`."""
    n = mask.shape[0]
    dev = mask.device
    cmag = (lambda x: x) if signed else torch.abs
    off = _window_offsets(w, dev)
    win_add = torch.where((off >= -w) & (off <= w) & (off != 0), 0.0, _BIG)
    nb = _blocks(n)
    bad = torch.empty(nb * MXU_BLOCK, dtype=torch.bool, device=dev)
    step = _chunk_blocks(w)
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        cx, cy, cz, cnx, cny, cnz, cv, cdk = _gather_blocks(
            [*pos, *nrm, mask, dk], [_POS_FILL] * 3 + [0.0] * 3 + [False, 0.0],
            w, b0, b1)
        ox, oy, oz = _origin(cx, cy, cz, cv)
        cxo, cyo, czo = cx - ox, cy - oy, cz - oz
        q = slice(w, w + MXU_BLOCK)
        qxo, qyo, qzo, qv = cxo[:, q], cyo[:, q], czo[:, q], cv[:, q]
        qnx, qny, qnz, qdk = cnx[:, q], cny[:, q], cnz[:, q], cdk[:, q]
        d = _distance(cxo, cyo, czo, cv, qxo, qyo, qzo, qv)
        in_ball = (d + win_add) <= qdk[:, None, :]
        del d
        cn = (cnx[:, :, None] * qnx[:, None, :]
              + cny[:, :, None] * qny[:, None, :]
              + cnz[:, :, None] * qnz[:, None, :])
        cp = (cxo[:, :, None] * qnx[:, None, :]
              + cyo[:, :, None] * qny[:, None, :]
              + czo[:, :, None] * qnz[:, None, :])
        qdotn = qxo * qnx + qyo * qny + qzo * qnz
        pd = torch.abs(cp - qdotn[:, None, :])
        ok = (pd <= th_thickness) & (cmag(cn) >= th_normal_cos)
        bad[b0 * MXU_BLOCK:b1 * MXU_BLOCK] = (in_ball & ~ok).any(1).reshape(-1)
    return mask & ~bad[:n]


def seed_sweep_mxu(pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos,
                   signed=False, group=None) -> torch.Tensor:
    """The depth-0 seed rule in block form → bool[n] seeds: the contract
    of :func:`buildingsegment_tpu_torch.ops.window_sweep.seed_sweep` in
    the module docstring's rounding.  With ``group`` the columns hold
    :func:`mxu_halo` rows a side and the S middle rows come back.  CUDA
    tensors launch the CUDA kernel, CPU tensors run
    :func:`seed_sweep_mxu_reference`."""
    args = (pos, nrm, mask, dk)
    kw = dict(w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
              signed=signed)
    if mask.is_cuda:
        out = kernels.seed_mxu_cuda(*args, **kw)
    else:
        out = seed_sweep_mxu_reference(*args, **kw)
    return _middle(group, w, mask, out)
