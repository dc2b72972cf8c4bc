"""Kernel #14, the exact kNN scan (``csrc/knn_exact.cu``).

The count is taken from the call's positions in and its lists out, and
not from the candidate tiles the call was given to visit, so that a
tighter prune or a tighter bound moves the kernel's share and not the
yardstick.  Bytes: the positions read once and the lists (squared
distances and indices) written once.  Operations: 9 a pair (3
subtractions, 3 multiplications, 2 additions and a compare) over the
pairs a tiling of the Morton-ordered rows into the call's query tiles
(``qt``, 128 rows) and candidate tiles (``ct``, 1,024 rows) must test:
each query tile's valid queries against every valid row of each
candidate tile whose box lies within the tile's exact final k-th
distance (the largest last entry of its valid rows' lists).  A kernel
that prunes in smaller groups of queries may test fewer pairs.
"""

import torch

from benchmark.roofline.common import nbytes

ENTRY = "knn_exact_cuda"

#: the validity test on the −3e7 sentinel of invalid rows
_VALID_GT = -1e7
#: query tiles a step of the count
_TILES_A_STEP = 1024


def _boxes(p, valid, t):
    pt = p.reshape(-1, t, 3)
    vt = valid.reshape(-1, t, 1)
    lo = torch.where(vt, pt, torch.inf).amin(1)
    hi = torch.where(vt, pt, -torch.inf).amax(1)
    return lo, hi, vt.sum((1, 2))


def tested_pairs(pos, last_d, qt: int, ct: int) -> int:
    """The pairs a ``qt`` × ``ct`` tiling must test (see the module's
    docstring): ``pos`` the (x, y, z) columns, ``last_d`` each row's
    final k-th squared distance."""
    p = torch.stack([c.double() for c in pos], 1)
    valid = p[:, 0] > _VALID_GT
    qlo, qhi, qn = _boxes(p, valid, qt)
    clo, chi, cn = _boxes(p, valid, ct)
    tau = torch.where(valid, last_d.double(), -torch.inf)
    tau = tau.reshape(-1, qt).amax(1)
    pairs = 0
    for q0 in range(0, qlo.shape[0], _TILES_A_STEP):
        q = slice(q0, q0 + _TILES_A_STEP)
        gap = torch.clamp_min(torch.maximum(clo[None] - qhi[q, None],
                                            qlo[q, None] - chi[None]), 0.0)
        need = (gap * gap).sum(-1) <= tau[q, None]
        pairs += int((need.double() * cn[None].double()).sum(1)
                     .mul(qn[q].double()).sum())
    return pairs


def work(args, kw, out):
    pos = args[0]
    best_d, best_i = out
    pairs = tested_pairs(pos, best_d[:, -1], kw["qt"], kw["ct"])
    return nbytes(pos) + nbytes(out), pairs * 9
