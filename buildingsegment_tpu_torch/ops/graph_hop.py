"""The graph solve's walk over the kNN edges: a sweep's hop and its union
hook.

Stand-in for the JAX package's XLA gathers and ``.at[].min`` scatters of
``one_hop`` and ``merge_labels`` (``buildingsegment_tpu/seg/region_grow.py``),
which no Pallas kernel replaced.  CUDA tensors launch the kernel of
``csrc/graph_hop.cu`` (``kernels.graph_hop_cuda``,
``kernels.graph_union_cuda``) or raise; CPU tensors run the plain
versions, the solve's own expressions.

Inputs, made once a solve by :func:`graph_edges` and :func:`graph_points`:

* ``nb`` int32[N, K−1]: the non-self kNN slots, row-major;
* ``nb_valid`` bool[N, K−1]: the edge gate (both ends valid, not the
  point itself, and within ``max_edge_dist`` where distances are given);
* ``points`` f32[N, 8]: rows (position, pad, normal, pad).

Made once a sweep by :func:`model_table`: ``models`` f32[ng, 8], rows
(unit normal, pad, centre, pad) indexed by label; ``ng`` is the "no
label" value, ``inf``.  Labels lie in [0, ng].

A model (n, c) accepts a point (p, q) iff
``|((px − cx)·nx + (py − cy)·ny) + (pz − cz)·nz| <= th_thickness`` and
``cmag((qx·nx + qy·ny) + qz·nz) >= th_normal_cos`` (float32 operations in
that order, thresholds as float32; ``cmag`` is ``abs`` unless
``signed``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from buildingsegment_tpu_torch import kernels

__all__ = [
    "graph_edges", "graph_points", "model_table",
    "graph_hop", "graph_hop_reference",
    "graph_union_hooks", "graph_union_reference",
]


def graph_edges(neigh_idx: torch.Tensor, mask: torch.Tensor,
                neigh_sq_dist: Optional[torch.Tensor] = None,
                max_edge_dist: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nb, nb_valid) of a kNN graph ``neigh_idx`` [N, K] (self at slot
    0): the edges i → neigh_idx[i, 1:], valid where both ends are, the
    edge is not the point itself and, with distances and a gate, its
    squared length is at most float32(max_edge_dist)²."""
    nb = neigh_idx[:, 1:].to(torch.int32).contiguous()
    rows = torch.arange(nb.shape[0], dtype=torch.int32, device=nb.device)
    nb_valid = mask[nb.long()] & mask[:, None] & (nb != rows[:, None])
    if neigh_sq_dist is not None and max_edge_dist is not None:
        gate = float(np.float32(max_edge_dist) * np.float32(max_edge_dist))
        nb_valid = nb_valid & (neigh_sq_dist[:, 1:] <= gate)
    return nb, nb_valid


def graph_points(pos: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """f32[N, 8] rows (position, pad, normal, pad) of f32 [N, 3] columns;
    the pads hold copies and are never read."""
    return torch.cat([pos, pos[:, :1], nrm, nrm[:, :1]], 1)


def model_table(model_n: torch.Tensor, model_c: torch.Tensor) -> torch.Tensor:
    """f32[ng, 8] rows (unit normal, pad, centre, pad), one launch."""
    return torch.cat([model_n, model_n[:, :1], model_c, model_c[:, :1]], 1)


def _accepts(models, t_pos, t_nrm, lbl, th_thickness, th_normal_cos, cmag):
    """Does the model of label ``lbl`` accept a point (t_pos, t_nrm)?"""
    ng = models.shape[0]
    model_n, model_c = models[:, 0:3], models[:, 4:7]
    safe = lbl.clamp(0, ng - 1).long()
    sn = model_n[safe]
    d = torch.abs(_sum3((t_pos - model_c[safe]) * sn))
    c = cmag(_sum3(t_nrm * sn))
    return (lbl < ng) & (d <= th_thickness) & (c >= th_normal_cos)


def _sum3(t: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, in the order (t0 + t1) + t2."""
    return t[..., 0] + t[..., 1] + t[..., 2]


def graph_hop_reference(label, nb, nb_valid, points, models, *,
                        th_thickness, th_normal_cos, signed=False):
    """Plain PyTorch version of :func:`graph_hop`."""
    cmag = (lambda x: x) if signed else torch.abs
    acc = dict(th_thickness=th_thickness, th_normal_cos=th_normal_cos,
               cmag=cmag)
    inf = models.shape[0]
    n = label.shape[0]
    nb = nb.long()
    pos, nrm = points[:, 0:3], points[:, 4:7]
    # reverse edges (gather): a point adopts its neighbours' labels
    nb_label = label[nb]
    ok = _accepts(models, pos[:, None, :], nrm[:, None, :], nb_label,
                  **acc) & nb_valid
    new = torch.minimum(label, torch.where(ok, nb_label, inf).amin(dim=1))
    # forward edges (scatter): i pushes its label to neigh[i, 1:]
    own = label[:, None].expand_as(nb)
    push_ok = _accepts(models, pos[nb], nrm[nb], own, **acc) & nb_valid
    scat = torch.full((n + 1,), inf, dtype=torch.int32, device=label.device)
    scat.scatter_reduce_(0, torch.where(push_ok, nb, n).reshape(-1),
                         torch.where(push_ok, own, inf).reshape(-1), "amin")
    return torch.minimum(new, scat[:n])


def graph_hop(label: torch.Tensor, nb: torch.Tensor, nb_valid: torch.Tensor,
              points: torch.Tensor, models: torch.Tensor, *,
              th_thickness: float, th_normal_cos: float,
              signed: bool = False) -> torch.Tensor:
    """One hop of the graph solve → int32[N]: ``min(label[i], adopted,
    pushed)``, where point i adopts a neighbour t's label whose model
    accepts i (reverse edges) and takes every label a neighbour i' pushes
    whose model accepts i (forward edges), over the valid edges only.

    CUDA tensors launch ``csrc/graph_hop.cu`` (K−1 ≤ 32), CPU tensors run
    :func:`graph_hop_reference`."""
    if label.is_cuda:
        return kernels.graph_hop_cuda(
            label, nb, nb_valid, points, models, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, signed=signed)
    return graph_hop_reference(
        label, nb, nb_valid, points, models, th_thickness=th_thickness,
        th_normal_cos=th_normal_cos, signed=signed)


def graph_union_reference(label, nb, nb_valid, models, *, th_thickness,
                          th_normal_cos, signed=False):
    """Plain PyTorch version of :func:`graph_union_hooks`."""
    cmag = (lambda x: x) if signed else torch.abs
    acc = dict(th_thickness=th_thickness, th_normal_cos=th_normal_cos,
               cmag=cmag)
    ng = inf = models.shape[0]
    model_n, model_c = models[:, 0:3], models[:, 4:7]
    nb = nb.long()
    la = label[:, None].expand_as(nb)
    lb = label[nb]
    sa, sb = la.clamp(0, ng - 1).long(), lb.clamp(0, ng - 1).long()
    ok = (
        (la < inf) & (lb < inf) & (la != lb) & nb_valid
        & _accepts(models, model_c[sb], model_n[sb], la, **acc)
        & _accepts(models, model_c[sa], model_n[sa], lb, **acc)
    )
    idx = torch.where(ok, torch.maximum(la, lb), ng)
    val = torch.where(ok, torch.minimum(la, lb), inf)
    rows = torch.arange(ng, dtype=torch.int32, device=label.device)
    parent = torch.cat([rows, rows.new_full((1,), inf)])
    parent.scatter_reduce_(0, idx.reshape(-1).long(), val.reshape(-1),
                           "amin")
    return parent[:ng]


def graph_union_hooks(label: torch.Tensor, nb: torch.Tensor,
                      nb_valid: torch.Tensor, models: torch.Tensor, *,
                      th_thickness: float, th_normal_cos: float,
                      signed: bool = False) -> torch.Tensor:
    """The union's hooked parent table → int32[ng]: the identity, each
    label hooked to the least label it is joined to by a valid edge whose
    two ends carry different labels (both below ``ng``) whose models
    accept each other's centre and normal both ways (before any jump
    round).

    CUDA tensors launch ``csrc/graph_hop.cu`` (K−1 ≤ 32), CPU tensors run
    :func:`graph_union_reference`."""
    if label.is_cuda:
        return kernels.graph_union_cuda(
            label, nb, nb_valid, models, th_thickness=th_thickness,
            th_normal_cos=th_normal_cos, signed=signed)
    return graph_union_reference(
        label, nb, nb_valid, models, th_thickness=th_thickness,
        th_normal_cos=th_normal_cos, signed=signed)
