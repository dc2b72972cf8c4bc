"""Segment sums and lookups over the small plane table of the finalize.

Port of ``plane_payload_moment_sums`` (kernel ``_paymom_kernel``) and
``table_lookup`` (kernel ``_lookup_kernel``) in
``buildingsegment_tpu/ops/segsum.py``.  The TPU kernels replaced XLA's
sort-based scatter and gather with one-hot matmuls over the live
128-id chunks; on Hopper a gather is a gather, and a segment sum is a
fixed-order reduction (``csrc/segsum.cu``).

Live bound: both TPU kernels touch only the id chunks below
``ceil(n_live / 128)``, so an id counts iff ``0 ≤ id < ceil128(n_live)``
(capped at the table) — ids just above ``n_live`` inside the last live
chunk still count.  The port keeps that rule.

Summation order (both versions): block b of ``kernels.PAYMOM_ROWS``
rows sums its rows in row order into its own partial table, then the
partial tables are added in block order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buildingsegment_tpu_torch import kernels

__all__ = [
    "plane_payload_moment_sums", "payload_moment_sums_reference",
    "table_lookup", "table_lookup_reference",
]


def block_order_sums(key_block: torch.Tensor, key_id: torch.Tensor,
                     rows: torch.Tensor, nblk: int, size: int) -> torch.Tensor:
    """[size, C] sums of ``rows`` [M, C] by id, each block's rows added in
    row order into its own table (accumulating ``index_put_`` runs
    sequentially on the CPU and after a stable sort on the card), then the
    block tables added in block order."""
    part = torch.zeros((nblk * size, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    part.index_put_((key_block * size + key_id,), rows, accumulate=True)
    part = part.view(nblk, size, rows.shape[1])
    acc = torch.zeros((size, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for b in range(nblk):
        acc = acc + part[b]
    return acc


def payload_moment_sums_reference(
    ids, payload, q, n_live, *, table_cap,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`plane_payload_moment_sums`."""
    n = ids.shape[0]
    dev = ids.device
    cap128 = kernels.ceil128(table_cap)
    bound = min(kernels.ceil128(n_live), cap128)
    sums = torch.zeros((cap128, 8), dtype=torch.float32, device=dev)
    moments = torch.zeros((cap128, 6), dtype=torch.float32, device=dev)
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
                           torch.cat([pay, mom], 1), nblk, bound)
    sums[:bound] = acc[:, :8]
    moments[:bound] = acc[:, 8:]
    return sums, moments


def plane_payload_moment_sums(ids, payload, q, n_live, *, table_cap):
    """Payload sums and second moments about per-id centers, one pass.

    Args:
        ids: int32[n] row ids; a row counts iff 0 ≤ id < ceil128(n_live)
            (excluded rows carry an id at or above that bound).
        payload: f32[n, 8] rows [1, n̂, p, |p|²] (p in columns 4:7).
        q: f32[Q, 3] per-id reference centers (ids ≥ Q center at 0).
        n_live: live-id bound (host int).
        table_cap: table capacity, rounded up to 128.

    Returns (sums f32[cap128, 8], moments f32[cap128, 6]); moment columns
    are (xx, yy, zz, xy, xz, yz) of p − q[id].  CUDA tensors launch the
    CUDA kernel, CPU tensors run :func:`payload_moment_sums_reference`.
    """
    if ids.is_cuda:
        return kernels.payload_moment_sums_cuda(
            ids, payload, q, n_live, table_cap=table_cap)
    return payload_moment_sums_reference(
        ids, payload, q, n_live, table_cap=table_cap)


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
