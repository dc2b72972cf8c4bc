"""Halo exchange for Morton-range point shards.

Port of ``buildingsegment_tpu/dist/halo.py``.  The cloud is
Morton-sorted once and split into contiguous row ranges, one a rank, so
every ±w window op (the stats and seed sweeps, label propagation,
refinement) needs only the last / first w rows of the ring neighbours,
exchanged here by :meth:`ShardGroup.shift` (``batch_isend_irecv``).

Rows past the global edges get ``fill``.  The JAX package fills zeros
and gates them with the exchanged mask; the port's sweeps call with the
one-device fill of each column (position −3e7, normal 0, mask False,
label "none"; a 2-D array may take one value a column), so a kernel
that reads a masked row's columns sees at a global edge exactly what it
sees on one device.  ``fill`` defaults to 0,
JAX's rows.

When w exceeds the local rows S (a deep multigrid level over many
shards), the exchange walks the ring ``ceil(w / S)`` hops, at most the
world size, moving whole shards, so each side still gets exactly w rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buildingsegment_tpu_torch.dist.mesh import fill_rows

__all__ = ["ring_halo", "halo_pad"]


def _tail(x: torch.Tensor, w: int, fill) -> torch.Tensor:
    """The last ``w`` rows, ``fill`` rows in front when x is shorter."""
    s = x.shape[0]
    if s >= w:
        return x[s - w:]
    return torch.cat([fill_rows(x.new_empty((w - s,) + x.shape[1:]), fill),
                      x], 0)


def _head(x: torch.Tensor, w: int, fill) -> torch.Tensor:
    """The first ``w`` rows, ``fill`` rows behind when x is shorter."""
    s = x.shape[0]
    if s >= w:
        return x[:w]
    return torch.cat([x, fill_rows(x.new_empty((w - s,) + x.shape[1:]),
                                   fill)], 0)


def ring_halo(x: torch.Tensor, w: int, group,
              fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right): exactly ``w`` halo rows a side along dim 0.

    left holds the ``w`` rows just before this rank's rows in global
    order, right the ``w`` rows just after; rows past the global edges
    are ``fill``.  One exchange of the edge rows when the local rows
    cover ``w``; otherwise ``ceil(w / S)`` hops of whole shards (after h
    hops rank i holds rank i ∓ h's rows; the fill rides along past the
    edge), capped at the world size.
    """
    if w <= 0:
        empty = x[:0]
        return empty, empty
    s = x.shape[0]
    hops = min(-(-w // s), group.world) if s else group.world
    if hops <= 1:
        return group.shift(_tail(x, w, fill), _head(x, w, fill), fill)
    lparts, rparts = [], []
    lbuf = rbuf = x
    for h in range(hops):
        lbuf, rbuf = group.shift(lbuf, rbuf, fill, tag=h)
        lparts.insert(0, lbuf)  # rank i − h's rows go first
        rparts.append(rbuf)
    return (_tail(torch.cat(lparts, 0), w, fill),
            _head(torch.cat(rparts, 0), w, fill))


def halo_pad(x: torch.Tensor, w: int, group, fill=0) -> torch.Tensor:
    """[S + 2w, ...]: the previous ranks' last w rows, this rank's S
    rows, the next ranks' first w rows (``fill`` past the global
    edges).  Without a group (``group`` None) the halos are ``fill``
    rows, the one-device padding."""
    if group is None:
        pad = fill_rows(x.new_empty((w,) + x.shape[1:]), fill)
        return torch.cat([pad, x, pad], 0)
    left, right = ring_halo(x, w, group, fill=fill)
    return torch.cat([left, x, right], 0)
