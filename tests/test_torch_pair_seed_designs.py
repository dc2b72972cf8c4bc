"""The tile designs of #2's pair phase and of #16, rebuilt on the CPU.

``csrc/compact_sweep.cu`` ``pairs_kernel`` tests, for each live column
j, only the partner rows i < min(j, parent[j]) (parent[j] ≤ j on entry:
the model refresh sets it to j and the hooks only lower it, so a pair
through a row at or past that bound cannot lower it), in tiles of 128
rows × 32 columns, 32 consecutive rows a warp, each lane stopping at its
first passing row, the tiles' column minima joined by an integer min.
``pair_tiles`` below rebuilds that walk in plain PyTorch and is held bit
for bit against ``ops.compact_sweep.compact_pair_parents`` (section H of
the plain version, every ordered pair tested).

``csrc/stats_mxu.cu`` ``seed_mxu_kernel`` walks only a query's 2w window
slots while its ball is below 1e29 and every staged |c−o|² of its block
below 1e28: a candidate outside the window has the gate value D + 1e30 ≥
9e29 there.  Other queries walk all C = 128 + 2w candidates.
``window_walk`` rebuilds that rule and is held bit for bit against
``ops.stats_mxu.seed_sweep_mxu_reference``.

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.ops.compact_sweep import (
    COMPACT_L,
    compact_pair_parents,
)
from buildingsegment_tpu_torch.ops.stats_mxu import (
    MXU_BLOCK,
    _distance,
    _gather_blocks,
    _origin,
    _window_offsets,
    seed_sweep_mxu_reference,
)

TH, CTH, EDGE = 300.0, 0.88, 600.0
PAIR_ROWS, PAIR_COLS, WARP_ROWS = 128, 32, 32
SAFE_C2, BIG_CUT = 1e28, float(np.float32(1e29))


def pair_ok(ptab, th, cth, root_gate, signed):
    """[b, b] pass flags of row i (partner) and column j, from the [b, 10]
    table (n, c, reach, count, n·c, |c|²) with the kernel's arithmetic."""
    a = [ptab[:, k, None] for k in range(10)]   # row i
    bj = [ptab[None, :, k] for k in range(10)]  # column j
    nc = a[3] * bj[0] + a[4] * bj[1] + a[5] * bj[2]
    cn = a[0] * bj[3] + a[1] * bj[4] + a[2] * bj[5]
    nn = a[0] * bj[0] + a[1] * bj[1] + a[2] * bj[2]
    cc = a[3] * bj[3] + a[4] * bj[4] + a[5] * bj[5]
    sep = nc - bj[8]
    sep_b = a[8] - cn
    cosab = nn if signed else torch.abs(nn)
    d2 = a[9] + bj[9] - 2.0 * cc
    inplane2 = torch.clamp_min(d2 - sep * sep, 0.0)
    reach = a[6] + bj[6] + root_gate
    return ((torch.abs(sep) <= th) & (torch.abs(sep_b) <= th)
            & (cosab >= cth) & (inplane2 <= reach * reach)
            & (a[7] > 0) & (bj[7] > 0))


def pair_tiles(parent, mn, ctr, reach, cnt, bound, *, lc, th_thickness,
               th_normal_cos, root_gate, signed=False):
    """``pairs_kernel``'s walk in plain PyTorch; returns the new parent."""
    b = int(bound)
    ncd = mn[0] * ctr[0] + mn[1] * ctr[1] + mn[2] * ctr[2]
    ccd = ctr[0] * ctr[0] + ctr[1] * ctr[1] + ctr[2] * ctr[2]
    ptab = torch.stack([*mn, *ctr, reach, cnt, ncd, ccd], 1)[:b]
    ok = pair_ok(ptab, th_thickness, th_normal_cos, root_gate, signed)
    ids = torch.arange(b)
    lim = torch.where(cnt[:b] > 0, torch.minimum(ids, parent[:b].long()), 0)
    out = parent.clone()
    for j0 in range(0, b, PAIR_COLS):
        cols = slice(j0, min(j0 + PAIR_COLS, b))
        top = int(lim[cols].max())
        for r0 in range(0, top, PAIR_ROWS):  # tiles past top exit at once
            for w0 in range(r0, min(r0 + PAIR_ROWS, top), WARP_ROWS):
                rows = torch.arange(w0, min(w0 + WARP_ROWS, top))
                hit = ok[rows][:, cols] & (rows[:, None] < lim[None, cols])
                # each lane's first passing row of the warp's 32
                first = torch.where(hit, rows[:, None], lc).amin(0)
                out[cols] = torch.minimum(out[cols], first.to(out.dtype))
    return out


def _pair_problem(case, bound, signed, rng):
    """(parent, mn, ctr, reach, cnt) over lc slots: models on a few planes
    (one plane for "coplanar"), a tenth of the slots dead, the parents
    hooked below their slot at random."""
    lc = COMPACT_L
    if case == "coplanar":
        normals = np.array([[0.0, 0.0, 1.0]])
    else:
        normals = rng.normal(size=(4, 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    which = rng.integers(0, len(normals), lc)
    mn = normals[which] * (rng.choice([-1.0, 1.0], (lc, 1)) if signed else 1)
    # centers within a band of their plane, spread over 8 m
    ctr = rng.uniform(0, 8000, (lc, 3))
    off = (ctr * normals[which]).sum(1, keepdims=True)
    ctr = ctr - normals[which] * (off - rng.normal(0, 100, (lc, 1)))
    reach = rng.uniform(0, 400, lc)
    cnt = rng.integers(1, 50, lc).astype(np.float64)
    cnt[rng.random(lc) < 0.1] = 0.0
    cnt[bound:] = 0.0
    parent = np.arange(lc)
    hooked = rng.random(lc) < 0.3
    parent[hooked] = (rng.random(hooked.sum()) * parent[hooked]).astype(int)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return (torch.from_numpy(parent.astype(np.int32)), f(mn.T), f(ctr.T),
            f(reach), f(cnt))


@pytest.mark.parametrize("case,bound,signed", [
    ("planes", 1, False), ("planes", 127, False), ("planes", 128, False),
    ("planes", 129, True), ("planes", 700, False), ("planes", 2048, False),
    ("planes", 2048, True), ("coplanar", 700, False),
    ("coplanar", 2048, False),
])
def test_pair_tiles_match_plain(case, bound, signed):
    rng = np.random.default_rng(bound + 7 * signed)
    parent, mn, ctr, reach, cnt = _pair_problem(case, bound, signed, rng)
    kw = dict(lc=COMPACT_L, th_thickness=TH, th_normal_cos=CTH,
              root_gate=EDGE, signed=signed)
    want = compact_pair_parents(parent, mn, ctr, reach, cnt, bound, **kw)
    got = pair_tiles(parent, mn, ctr, reach, cnt, bound, **kw)
    assert torch.equal(got, want)
    if bound > 128:
        # the tests lowered parents, some through rows of another tile
        low = want[:bound] < parent[:bound]
        assert int(low.sum()) > bound // 20
        assert int((torch.arange(bound)[low] // 128
                    != want[:bound][low].long() // 128).sum()) > 0


def window_walk(pos, nrm, mask, dk, *, w, th_thickness, th_normal_cos,
                signed=False):
    """``seed_mxu_kernel``'s rule in plain PyTorch: bool[n] seeds."""
    n = mask.shape[0]
    nb = -(-n // MXU_BLOCK)
    cx, cy, cz, cnx, cny, cnz, cv, cdk = _gather_blocks(
        [*pos, *nrm, mask, dk], [-3e7] * 3 + [0.0] * 3 + [False, 0.0], w,
        0, nb)
    ox, oy, oz = _origin(cx, cy, cz, cv)
    cxo, cyo, czo = cx - ox, cy - oy, cz - oz
    c2 = cxo * cxo + cyo * cyo + czo * czo
    safe = ~(c2 >= SAFE_C2).any(1)                   # [blocks]
    q = slice(w, w + MXU_BLOCK)
    qxo, qyo, qzo, qv = cxo[:, q], cyo[:, q], czo[:, q], cv[:, q]
    qnx, qny, qnz, ball = cnx[:, q], cny[:, q], cnz[:, q], cdk[:, q]
    d = _distance(cxo, cyo, czo, cv, qxo, qyo, qzo, qv)
    off = _window_offsets(w, mask.device)
    slot = (off >= -w) & (off <= w) & (off != 0)    # [C, 128]
    win = torch.where(slot, 0.0, 1e30)
    window_only = safe[:, None] & (ball < BIG_CUT)  # [blocks, 128]
    in_ball = torch.where(window_only[:, None, :],
                          slot & (d + 0.0 <= ball[:, None, :]),
                          d + win <= ball[:, None, :])
    dn = (cnx[:, :, None] * qnx[:, None, :] + cny[:, :, None] * qny[:, None, :]
          + cnz[:, :, None] * qnz[:, None, :])
    dp = (cxo[:, :, None] * qnx[:, None, :] + cyo[:, :, None] * qny[:, None, :]
          + czo[:, :, None] * qnz[:, None, :])
    qdotn = qxo * qnx + qyo * qny + qzo * qnz
    pd = torch.abs(dp - qdotn[:, None, :])
    ok = (pd <= th_thickness) & ((dn if signed else torch.abs(dn))
                                 >= th_normal_cos)
    bad = (in_ball & ~ok).any(1).reshape(-1)[:n]
    return mask & ~bad


def _seed_cloud(case, rng):
    """(pos, nrm, mask, dk, scale) of 1,500 rows (not a multiple of 128)
    with a masked run: small span (coordinates < 256), building span,
    spread to 1e15 (blocks above the window walk's limit), or "extreme":
    clusters 7e18 from a point at 0 in every 64 rows, where the rounding
    of D reaches -1e31 and the full walk's result differs from the
    window's; balls at or above 1e29, +inf, NaN and negative on every
    fifth row."""
    n = 1500
    if case == "extreme":
        pos = 7e18 + rng.integers(0, 1000, (n, 3)) * 1e12
        pos[::64] = 0.0
    else:
        span = {"small": 250, "building": 9000, "huge": 1e15}[case]
        pos = rng.uniform(0, span, (n, 3))
        if case != "huge":
            pos = np.floor(pos)
        pos = pos[np.lexsort(pos.T[::-1])]  # near rows near in space
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[: n // 2] = [0.0, 0.6, 0.8]  # half of them agree
    mask = rng.random(n) < 0.9
    mask[300:420] = False
    scale = {"small": 1.0, "building": 300.0, "huge": 1e13,
             "extreme": 1e12}[case]
    dk = rng.uniform(100.0, 4000.0, n) * scale ** 2
    special = np.array([1e29, 5e29, 2e30, np.inf, np.nan, -1.0])
    dk[::5] = special[np.arange(len(dk[::5])) % len(special)]
    f = lambda a, t=torch.float32: torch.from_numpy(np.ascontiguousarray(a)
                                                    ).to(t)
    cols = lambda a: tuple(f(a[:, d]) for d in range(3))
    return cols(pos), cols(nrm), f(mask, torch.bool), f(dk), scale


@pytest.mark.parametrize("case,w,signed", [
    ("small", 16, False), ("small", 16, True), ("small", 1, False),
    ("small", 48, False), ("building", 16, False), ("building", 100, True),
    ("huge", 16, False), ("extreme", 16, False),
])
def test_window_walk_matches_plain(case, w, signed):
    rng = np.random.default_rng(w + 3 * signed)
    pos, nrm, mask, dk, scale = _seed_cloud(case, rng)
    kw = dict(w=w, th_thickness=30.0 * scale, th_normal_cos=CTH,
              signed=signed)
    want = seed_sweep_mxu_reference(pos, nrm, mask, dk, **kw)
    got = window_walk(pos, nrm, mask, dk, **kw)
    assert torch.equal(got, want)
    assert int(want.sum()) > 10 and int((mask & ~want).sum()) > 10
