"""The ±w window sweeps: label propagation, seed rule, refinement.

Port of ``label_sweep`` / ``_label_kernel``, ``seed_sweep_pair`` /
``_seed_kernel_sym`` and ``refine_table_sweep_pair`` /
``_refine_table_kernel_pair`` in
``buildingsegment_tpu/ops/window_sweep.py``.

``label_sweep`` (one sweep of the window solver): per sorted row i and
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

``seed_sweep`` (``csrc/seed_sweep.cu``) and ``refine_sweep``
(``csrc/refine_sweep.cu``) take the same SoA inputs; see their
docstrings.  Both are min/or chains over identical f32 operations, so
kernel and plain version agree bit for bit.

Sharded (``group``, a :class:`~buildingsegment_tpu_torch.dist.ShardGroup`):
every input column carries w halo rows each side, the ring neighbours'
rows or past the global edges the column's one-device fill
(:func:`halo_columns` for the columns that stay fixed over a level,
``group.halo_pad`` for the rest), and the sweep runs the same kernel on
those S + 2w rows and returns the middle S.  Each middle row sees the
candidates it sees on one device, so the result is the one-device
result of those rows (the JAX package's ``make_slab(..., axis_name)``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from buildingsegment_tpu_torch import kernels

__all__ = [
    "label_sweep", "label_sweep_reference", "seed_sweep",
    "seed_sweep_reference", "refine_sweep", "refine_sweep_reference",
    "halo_columns", "POS_FILL",
]

#: the position of a row outside the cloud (the slab fill)
POS_FILL = -3e7


def halo_columns(group, w: int, pos, nrm, mask):
    """The static columns of a window sweep with ``w`` halo rows a side:
    ((x, y, z), (nx, ny, nz), mask) of S + 2w rows, in one ring exchange
    (positions filled with :data:`POS_FILL`, normals with 0, the mask with
    False past the global edges)."""
    cols = torch.stack([*pos, *nrm, mask.float()], 1)
    pad = group.halo_pad(cols, w, fill=[POS_FILL] * 3 + [0.0] * 4)
    return (tuple(pad[:, d].contiguous() for d in range(3)),
            tuple(pad[:, 3 + d].contiguous() for d in range(3)),
            pad[:, 6] > 0.5)


def _middle(group, w: int, rows: torch.Tensor, out):
    """The S middle rows of a sweep's outputs over S + 2w halo-padded
    rows (all of them without a group)."""
    if group is None:
        return out
    if rows.shape[0] <= 2 * w:
        raise ValueError(f"sharded sweep: {rows.shape[0]} rows do not hold "
                         f"w={w} halo rows a side")
    n = rows.shape[0] - 2 * w
    if isinstance(out, tuple):
        return tuple(o[w:w + n] for o in out)
    return out[w:w + n]


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
    ppx, ppy, ppz = (_pad(a, w, POS_FILL) for a in pos)
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
    th_normal_cos, edge_gate2, inf_label, signed=False, group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One label-propagation sweep → (hop label int32[n], merge hook
    int32[n]; ``inf_label`` = none).

    ``pos``/``nrm``/``model_n``/``model_c`` are (x, y, z) triples of
    f32[n]; ``label`` int32[n]; ``mask`` bool[n].  With ``group`` every
    column holds w halo rows a side (fills: position −3e7, normal and
    model 0, label ``inf_label``, mask False) and the S middle rows come
    back (module docstring).  CUDA tensors launch the CUDA kernel, CPU
    tensors run :func:`label_sweep_reference`.
    """
    args = (pos, nrm, model_n, model_c, label, mask)
    kw = dict(
        w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
        edge_gate2=edge_gate2, inf_label=inf_label, signed=signed,
    )
    if label.is_cuda:
        out = kernels.label_sweep_cuda(*args, **kw)
    else:
        out = label_sweep_reference(*args, **kw)
    return _middle(group, w, label, out)


def seed_sweep_reference(
    pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos, signed=False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`seed_sweep` (the XLA loop of
    ``seg/region_grow.py`` window_seeds)."""
    n = mask.shape[0]
    cmag = (lambda x: x) if signed else torch.abs
    px, py, pz = pos
    nx, ny, nz = nrm
    ppx, ppy, ppz = (_pad(a, w, POS_FILL) for a in pos)
    pnx, pny, pnz = (_pad(a, w, 0.0) for a in nrm)
    pmask = _pad(mask, w, False)
    bad = torch.zeros(n, dtype=torch.bool, device=mask.device)
    for slot in range(2 * w):
        start = slot if slot < w else slot + 1
        sl = lambda a: a[start:start + n]
        dx = sl(ppx) - px
        dy = sl(ppy) - py
        dz = sl(ppz) - pz
        in_ball = (dx * dx + dy * dy + dz * dz <= dk) & sl(pmask) & mask
        pd = torch.abs(dx * nx + dy * ny + dz * nz)
        pc = cmag(sl(pnx) * nx + sl(pny) * ny + sl(pnz) * nz)
        bad = bad | (in_ball & ~((pd <= th_thickness) & (pc >= th_normal_cos)))
    return mask & ~bad


def seed_sweep(pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos,
               signed=False, group=None) -> torch.Tensor:
    """The depth-0 seed rule over ±w rows → bool[n] seeds.

    Row i is a seed iff it is valid and no valid window candidate j with
    |p_j − p_i|² ≤ dk_i fails |(p_j − p_i)·n_i| ≤ th and |n_j·n_i| ≥ cos.
    ``pos``/``nrm`` are (x, y, z) triples of f32[n], ``mask`` bool[n],
    ``dk`` f32[n] the squared k-th-NN ball.  With ``group`` every column
    holds w halo rows a side (a candidate's ``dk`` is never read, so its
    halo rows may hold anything) and the S middle rows come back.  CUDA
    tensors launch the CUDA kernel, CPU tensors run
    :func:`seed_sweep_reference`.
    """
    args = (pos, nrm, mask, dk)
    kw = dict(w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
              signed=signed)
    if mask.is_cuda:
        out = kernels.seed_sweep_cuda(*args, **kw)
    else:
        out = seed_sweep_reference(*args, **kw)
    return _middle(group, w, mask, out)


def refine_sweep_reference(
    pos, nrm, mask, pid, table, n_live, *, w, th_thickness, th_normal_cos,
    edge_gate2, signed=False, clean=False, adopt=True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`refine_sweep` (the XLA refine of
    ``seg/coarse.py`` step 3, with the kernel's fused ``clean``)."""
    n = mask.shape[0]
    cmag = (lambda x: x) if signed else torch.abs
    px, py, pz = pos
    nx, ny, nz = nrm
    ntab = min(kernels.ceil128(n_live), table.shape[0])
    has = (pid > 0) & mask
    t = torch.where(has & (pid <= ntab), pid - 1, 0).long()
    m = torch.where((has & (pid <= ntab))[:, None], table[t], 0.0)
    mnx, mny, mnz, mb = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    eff = torch.where(has, pid, 0)
    if clean:
        d_self = torch.abs(px * mnx + py * mny + pz * mnz - mb)
        c_self = cmag(nx * mnx + ny * mny + nz * mnz)
        self_ok = (d_self <= th_thickness) & (c_self >= th_normal_cos)
        eff = torch.where(self_ok, eff, 0)
    if not adopt:
        return eff
    big = torch.iinfo(torch.int32).max
    ppx, ppy, ppz = (_pad(a, w, POS_FILL) for a in pos)
    pmnx, pmny, pmnz, pmb = (_pad(a, w, 0.0) for a in (mnx, mny, mnz, mb))
    peff = _pad(eff, w, 0)
    best = torch.full_like(pid, big)
    for slot in range(2 * w):
        start = slot if slot < w else slot + 1
        sl = lambda a: a[start:start + n]
        dx = px - sl(ppx)
        dy = py - sl(ppy)
        dz = pz - sl(ppz)
        near = dx * dx + dy * dy + dz * dz <= edge_gate2
        cmnx, cmny, cmnz = sl(pmnx), sl(pmny), sl(pmnz)
        d = torch.abs(px * cmnx + py * cmny + pz * cmnz - sl(pmb))
        c = cmag(nx * cmnx + ny * cmny + nz * cmnz)
        cpid = sl(peff)
        ok = (cpid > 0) & near & mask & (d <= th_thickness) & (
            c >= th_normal_cos)
        best = torch.minimum(best, torch.where(ok, cpid, big))
    return torch.where(eff > 0, eff, torch.where(best < big, best, 0))


def refine_sweep(pos, nrm, mask, pid, table, n_live, *, w, th_thickness,
                 th_normal_cos, edge_gate2, signed=False, clean=False,
                 adopt=True, group=None) -> torch.Tensor:
    """One refinement sweep against the [P] plane table → int32[n] plane
    ids (0 = none).

    ``pid`` int32[n] is each row's plane id (0 = none); ``table``
    f32[P, 4] holds plane id p's unit normal and offset b = n·c in row
    p − 1; only ids up to ceil128(n_live) read the table (the TPU
    kernel's live chunks), others see a zero model.  A row keeps its id
    if it is valid and — with ``clean`` — its own plane still accepts it
    (|p·n − b| ≤ th and |n_i·n| ≥ cos); otherwise (with ``adopt``) it
    takes the smallest kept id of a valid window candidate within the
    edge gate whose plane accepts it.  ``clean`` applies to candidates
    too.  With ``group`` every column holds w halo rows a side (fills:
    position −3e7, normal 0, mask False, pid 0; the table is the same on
    every rank) and the S middle rows come back.  CUDA tensors launch
    the CUDA kernel, CPU tensors run :func:`refine_sweep_reference`.
    """
    args = (pos, nrm, mask, pid, table, n_live)
    kw = dict(w=w, th_thickness=th_thickness, th_normal_cos=th_normal_cos,
              edge_gate2=edge_gate2, signed=signed, clean=clean, adopt=adopt)
    if mask.is_cuda:
        out = kernels.refine_sweep_cuda(*args, **kw)
    else:
        out = refine_sweep_reference(*args, **kw)
    return _middle(group, w, mask, out)
