"""The window label-propagation sweep (one sweep of the window solver).

Port of ``label_sweep`` / ``_label_kernel`` in
``buildingsegment_tpu/ops/window_sweep.py``.  Per sorted row i and
every window offset o ∈ {−w…−1, +1…+w}, with candidate j = i + o inside
the edge gate (both rows valid, |p_i − p_j|² ≤ edge_gate2):

  * hop: the smallest candidate label whose region model accepts row i
    (|(p_i − c̄_j)·n̄_j| ≤ th and |n_i·n̄_j| ≥ cos);
  * merge hook: the smallest candidate label below row i's own label
    whose model and row i's model accept each other's centers.

The TPU kernel packed 14 component rows into a padded f32 slab; here the
components are passed directly (f32 [n] each, labels int32 with
``inf_label`` as "none", mask bool) and a candidate outside [0, n)
counts as masked, which is what the slab's sentinel fill does.  Every
test is an exact min/or chain over identical f32 operations, so the
CUDA kernel (``csrc/label_sweep.cu``) and :func:`label_sweep_reference`
agree bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from buildingsegment_tpu_torch import kernels

__all__ = ["label_sweep", "label_sweep_reference"]

_POS_FILL = -3e7


def _pad(a: torch.Tensor, w: int, fill) -> torch.Tensor:
    f = torch.full((w,), fill, dtype=a.dtype, device=a.device)
    return torch.cat([f, a, f])


def label_sweep_reference(
    pos: Sequence[torch.Tensor],
    nrm: Sequence[torch.Tensor],
    model_n: Sequence[torch.Tensor],
    model_c: Sequence[torch.Tensor],
    label: torch.Tensor,
    mask: torch.Tensor,
    *,
    w: int,
    th_thickness: float,
    th_normal_cos: float,
    edge_gate2: float,
    inf_label: int,
    signed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`label_sweep` (the XLA loop of
    ``seg/region_grow.py`` window_body step 3)."""
    n = label.shape[0]
    cmag = (lambda x: x) if signed else torch.abs
    px, py, pz = pos
    nx, ny, nz = nrm
    mnx, mny, mnz = model_n
    mcx, mcy, mcz = model_c
    ppx, ppy, ppz = (_pad(a, w, _POS_FILL) for a in pos)
    pmnx, pmny, pmnz = (_pad(a, w, 0.0) for a in model_n)
    pmcx, pmcy, pmcz = (_pad(a, w, 0.0) for a in model_c)
    plab = _pad(label, w, inf_label)
    pmask = _pad(mask, w, False)
    has = label < inf_label
    new = label
    best = torch.full_like(label, inf_label)
    for slot in range(2 * w):
        start = slot if slot < w else slot + 1  # skip offset 0
        sl = lambda a: a[start:start + n]
        clab = sl(plab)
        dx = px - sl(ppx)
        dy = py - sl(ppy)
        dz = pz - sl(ppz)
        near = (dx * dx + dy * dy + dz * dz <= edge_gate2) & sl(pmask) & mask
        cmnx, cmny, cmnz = sl(pmnx), sl(pmny), sl(pmnz)
        cmcx, cmcy, cmcz = sl(pmcx), sl(pmcy), sl(pmcz)
        d = torch.abs(
            (px - cmcx) * cmnx + (py - cmcy) * cmny + (pz - cmcz) * cmnz
        )
        c = cmag(nx * cmnx + ny * cmny + nz * cmnz)
        hop_ok = (clab < inf_label) & near & (d <= th_thickness) & (
            c >= th_normal_cos
        )
        new = torch.minimum(new, torch.where(hop_ok, clab, inf_label))
        dcx = cmcx - mcx
        dcy = cmcy - mcy
        dcz = cmcz - mcz
        mutual = (
            (torch.abs(dcx * mnx + dcy * mny + dcz * mnz) <= th_thickness)
            & (torch.abs(dcx * cmnx + dcy * cmny + dcz * cmnz) <= th_thickness)
            & (cmag(mnx * cmnx + mny * cmny + mnz * cmnz) >= th_normal_cos)
        )
        mrg_ok = has & (clab < label) & near & mutual
        best = torch.minimum(best, torch.where(mrg_ok, clab, inf_label))
    return new, best


def label_sweep(
    pos, nrm, model_n, model_c, label, mask, *, w, th_thickness,
    th_normal_cos, edge_gate2, inf_label, signed=False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One label-propagation sweep → (hop label int32[n], merge hook
    int32[n]; ``inf_label`` = none).

    ``pos``/``nrm``/``model_n``/``model_c`` are (x, y, z) triples of
    f32[n]; ``label`` int32[n]; ``mask`` bool[n].  CUDA tensors launch
    the CUDA kernel, CPU tensors run :func:`label_sweep_reference`.
    """
    args = (pos, nrm, model_n, model_c, label, mask)
    kw = dict(
        w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        edge_gate2=edge_gate2, inf_label=inf_label, signed=signed,
    )
    if label.is_cuda:
        return kernels.label_sweep_cuda(*args, **kw)
    return label_sweep_reference(*args, **kw)
