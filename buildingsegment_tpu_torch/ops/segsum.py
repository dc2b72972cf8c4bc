"""Segment sums and lookups over a small id table.

Port of ``plane_payload_moment_sums`` (kernel ``_paymom_kernel``),
``table_lookup`` (kernel ``_lookup_kernel``), ``table_lookup_cols``
(kernel ``_lookup_cols_kernel``) and ``plane_sums`` (kernel
``_segsum_kernel``; ``plane_sums_t``/``_segsum_t_kernel`` is the same
function in transposed layout) in ``buildingsegment_tpu/ops/segsum.py``.
The first two serve the multigrid finalize, ``plane_sums`` the raster's
ground histogram; ``table_lookup_cols`` has no caller, in the JAX
package either.  The TPU kernels replaced XLA's
sort-based scatter and gather with one-hot matmuls over the live
128-id chunks; on Hopper a gather is a gather, and a segment sum is a
fixed-order reduction (``csrc/segsum.cu``).

Live bound: the TPU kernels touch only the id chunks below
``ceil(n_live / 128)``, so an id counts iff ``0 ≤ id < ceil128(n_live)``
(capped at the table) — ids just above ``n_live`` inside the last live
chunk still count.  The port keeps that rule.

Summation order (kernel and plain version alike): block b of
``kernels.PAYMOM_ROWS`` (``kernels.SEGSUM_ROWS`` for ``plane_sums``)
rows sums its rows in row order into its own partial table, then the
partial tables are added in block order — onto 0, or onto ``init``
(``plane_payload_moment_sums``): a shard continuing the sums of the
shards before it, which for a shard of whole blocks gives the one-device
sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from buildingsegment_tpu_torch import kernels

__all__ = [
    "row_order_sums",
    "block_order_sums",
    "plane_payload_moment_sums", "payload_moment_sums_reference",
    "table_lookup", "table_lookup_reference",
    "table_lookup_cols", "table_lookup_cols_reference",
    "plane_sums", "plane_sums_reference",
]


def row_order_sums(idx: torch.Tensor, rows: torch.Tensor, size: int,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[size, C] per-id sums of ``rows`` [M, C], each id's rows added to
    0.0 one after another in row order, so the sums do not change from
    run to run.  On the CPU ``index_add_`` walks the rows in order (the
    accumulating ``index_put_`` there adds them in parallel, in no fixed
    order); on the card the accumulating ``index_put_`` sorts the ids
    stably and adds each id's rows in order (``index_add_`` there uses
    float atomics).  That holds for rows of 2 columns or more: a single
    column goes to a kernel that sums runs of 32 or more equal ids in
    warp-strided partials, so one column is summed as two (a zero column
    beside it) and sliced back.

    ``init`` [size, C]: each id's sum starts from its row of ``init``
    instead (a shard continuing the sums of the shards before it); on the
    card its rows go first in the same sort, so they are added first."""
    cols = rows.shape[1]
    if rows.is_cuda:
        if init is not None:
            idx = torch.cat([torch.arange(size, dtype=idx.dtype,
                                          device=idx.device), idx])
            rows = torch.cat([init.to(rows.dtype), rows], 0)
        if cols == 1:
            rows = torch.cat([rows, torch.zeros_like(rows)], 1)
        out = torch.zeros((size, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        return out.index_put_((idx,), rows, accumulate=True)[:, :cols]
    if init is not None:
        return init.to(rows.dtype).clone().index_add_(0, idx, rows)
    out = torch.zeros((size, cols), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, idx, rows)


def block_order_sums(key_block: torch.Tensor, key_id: torch.Tensor,
                     rows: torch.Tensor, nblk: int, size: int,
                     init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[size, C] sums of ``rows`` [M, C] by id, each block's rows added in
    row order into its own table (:func:`row_order_sums`), then the block
    tables added in block order onto zeros, or onto ``init`` [size, C]."""
    part = row_order_sums(key_block * size + key_id, rows, nblk * size)
    part = part.view(nblk, size, rows.shape[1])
    if init is None:
        acc = torch.zeros((size, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
    else:
        acc = init.to(rows.dtype)
    for b in range(nblk):
        acc = acc + part[b]
    return acc


def payload_moment_sums_reference(
    ids, payload, q, n_live, *, table_cap, init=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`plane_payload_moment_sums`."""
    n = ids.shape[0]
    dev = ids.device
    cap128 = kernels.ceil128(table_cap)
    bound = min(kernels.ceil128(n_live), cap128)
    if init is None:
        sums = torch.zeros((cap128, 8), dtype=torch.float32, device=dev)
        moments = torch.zeros((cap128, 6), dtype=torch.float32, device=dev)
    else:
        sums, moments = (t.float().clone() for t in init)
    live = (ids >= 0) & (ids < bound)
    if bound == 0 or not bool(live.any()):
        return sums, moments
    rows = torch.nonzero(live)[:, 0]
    s = ids[rows].long()
    pay = payload[rows]
    nq = q.shape[0]
    qs = torch.where((s < nq)[:, None], q[s.clamp(max=nq - 1)], 0.0)
    dx = pay[:, 4] - qs[:, 0]
    dy = pay[:, 5] - qs[:, 1]
    dz = pay[:, 6] - qs[:, 2]
    mom = torch.stack([dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz],
                      1)
    nblk = -(-n // kernels.PAYMOM_ROWS)
    acc = block_order_sums(rows // kernels.PAYMOM_ROWS, s,
                           torch.cat([pay, mom], 1), nblk, bound,
                           init=torch.cat([sums[:bound], moments[:bound]], 1))
    sums[:bound] = acc[:, :8]
    moments[:bound] = acc[:, 8:]
    return sums, moments


def plane_payload_moment_sums(ids, payload, q, n_live, *, table_cap,
                              init=None):
    """Payload sums and second moments about per-id centers, one pass.

    Args:
        ids: int32[n] row ids; a row counts iff 0 ≤ id < ceil128(n_live)
            (excluded rows carry an id at or above that bound).
        payload: f32[n, 8] rows [1, n̂, p, |p|²] (p in columns 4:7).
        q: f32[Q, 3] per-id reference centers (ids ≥ Q center at 0).
        n_live: live-id bound (host int).
        table_cap: table capacity, rounded up to 128.
        init: None, or (sums, moments) of the same shapes as the result:
            the block tables are added onto these (module docstring).

    Returns (sums f32[cap128, 8], moments f32[cap128, 6]); moment columns
    are (xx, yy, zz, xy, xz, yz) of p − q[id].  CUDA tensors launch the
    CUDA kernel, CPU tensors run :func:`payload_moment_sums_reference`.
    """
    if ids.is_cuda:
        return kernels.payload_moment_sums_cuda(
            ids, payload, q, n_live, table_cap=table_cap, init=init)
    return payload_moment_sums_reference(
        ids, payload, q, n_live, table_cap=table_cap, init=init)


def table_lookup_reference(ids, lut, n_live) -> torch.Tensor:
    """Plain PyTorch version of :func:`table_lookup`."""
    bound = min(kernels.ceil128(n_live), lut.shape[0])
    ok = (ids >= 0) & (ids < bound)
    return torch.where(ok, lut[ids.clamp(0, max(bound - 1, 0)).long()], 0)


def table_lookup(ids, lut, n_live) -> torch.Tensor:
    """``lut[ids]`` for ids in [0, ceil128(n_live)), 0 elsewhere.

    ``ids`` int32[n], ``lut`` int32[L] (entries past L read 0).  CUDA
    tensors launch the CUDA kernel, CPU tensors run
    :func:`table_lookup_reference`.
    """
    if ids.is_cuda:
        return kernels.table_lookup_cuda(ids, lut, n_live)
    return table_lookup_reference(ids, lut, n_live)


def table_lookup_cols_reference(ids, lut, n_live) -> torch.Tensor:
    """Plain PyTorch version of :func:`table_lookup_cols`."""
    cap, cols = lut.shape
    if not 1 <= cols <= kernels.LOOKUP_COLS_MAX:
        raise ValueError(f"table_lookup_cols: lut must be [cap, 1..8], got "
                         f"{tuple(lut.shape)}")
    bound = min(kernels.ceil128(n_live), cap)
    out = torch.zeros((cols, ids.shape[0]), dtype=torch.float32,
                      device=ids.device)
    if bound == 0:
        return out
    ok = (ids >= 0) & (ids < bound)
    rows = torch.index_select(lut.float(), 0,
                              ids.clamp(0, bound - 1).long())
    # + 0: the TPU kernel's zero-initialised one-hot sum turns −0 into +0
    return torch.where(ok[None, :], rows.T + 0.0, out)


def table_lookup_cols(ids, lut, n_live) -> torch.Tensor:
    """``lut[ids, :]`` for a small table, column-major → f32[cols, n].

    ``ids`` int32[n]; ``lut`` f32[cap, cols], cols ≤ 8.  ``out[c, i]`` is
    ``lut[ids[i], c]`` for ids in [0, ceil128(n_live)) (capped at the
    table), 0 elsewhere.  CUDA tensors launch the CUDA kernel, CPU
    tensors run :func:`table_lookup_cols_reference`.
    """
    if ids.is_cuda:
        return kernels.table_lookup_cols_cuda(ids, lut, n_live)
    return table_lookup_cols_reference(ids, lut, n_live)


def plane_sums_reference(ids, payload, n_live, *, table_cap) -> torch.Tensor:
    """Plain PyTorch version of :func:`plane_sums`."""
    n, cols = payload.shape
    if not 1 <= cols <= kernels.SEGSUM_MAX_COLS:
        raise ValueError(f"plane_sums: payload must be [n, 1..128], got "
                         f"{tuple(payload.shape)}")
    cap128 = kernels.ceil128(table_cap)
    bound = min(kernels.ceil128(n_live), cap128)
    out = torch.zeros((cap128, cols), dtype=torch.float32, device=ids.device)
    live = (ids >= 0) & (ids < bound)
    if bound == 0 or not bool(live.any()):
        return out
    rows = torch.nonzero(live)[:, 0]
    nblk = -(-n // kernels.SEGSUM_ROWS)
    out[:bound] = block_order_sums(rows // kernels.SEGSUM_ROWS,
                                   ids[rows].long(), payload[rows].float(),
                                   nblk, bound)
    return out


def plane_sums(ids, payload, n_live, *, table_cap) -> torch.Tensor:
    """Segment-sum ``payload`` rows by integer id into a small table.

    Args:
        ids: int32[n]; a row counts iff 0 ≤ id < ceil128(n_live), capped
            at the table (rows the caller wants excluded carry an id at or
            above that bound, or below 0).
        payload: f32[n, cols], 1 ≤ cols ≤ 128.
        n_live: live-id bound (host int).
        table_cap: table capacity, rounded up to 128.

    Returns f32[cap128, cols]: row t is the sum of the payload rows with
    id t (zero at and above the live bound).  CUDA tensors launch the
    CUDA kernel, CPU tensors run :func:`plane_sums_reference`.
    """
    if ids.is_cuda:
        return kernels.plane_sums_cuda(ids, payload, n_live,
                                       table_cap=table_cap)
    return plane_sums_reference(ids, payload, n_live, table_cap=table_cap)
