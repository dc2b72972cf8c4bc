"""The premises of the redesigned #1 kernel, pinned on the CPU.

``csrc/label_sweep.cu`` (#1) stages a tile of 64 rows and its ±w halo
once, invalid rows and rows outside [0, n) coded as a NaN position, and
lets four lanes split a row's 2w slots, joined by ``min``.  It must
equal its plain version bit for bit.  These tests rebuild the design in
plain torch on the CPU, tile by tile and lane by lane, and hold it
against ``label_sweep_reference`` and against the JAX package's Pallas
kernel in interpret mode.  #14's design: tests/test_torch_tile_designs_knn.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.window_sweep import (
    label_sweep as jax_label_sweep,
    make_slab,
    pick_tile,
)
from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.window_sweep import label_sweep_reference
from buildingsegment_tpu_torch.utils import make_building_cloud

TH, CTH, EG2 = 300.0, 0.88, 600.0 ** 2
NAN = float("nan")


@pytest.fixture(scope="module")
def label_problem():
    """A small house, Morton-sorted, cut to 4,000 rows (not a multiple of
    the 64-row tile): rows 0–4 and the last 37 masked (rows at both ends),
    a masked run across the tile edge at row 1,024; labels in groups of 7
    rows with a fifth dropped, models from the label's row (the normal and
    a jittered position), so hops and merges both fire."""
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=240.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    cap = 4096
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos),
                                 torch.from_numpy(mask), True)
    spos = spos.float()
    _, _, nrm, _ = knn_normals_window_sorted(spos, smask, 16, window=32,
                                             radius=300.0, max_nn=50)
    n = 4000
    pos, nrm = spos[:n].numpy(), nrm[:n].numpy()
    mask = smask[:n].numpy().copy()
    mask[:5] = False
    mask[-37:] = False
    mask[1024 - 20:1024 + 15] = False
    rng = np.random.default_rng(3)
    label = (np.arange(n) // 7 * 7).astype(np.int32)
    label[rng.random(n) < 0.2] = n
    label[~mask] = n
    src = np.minimum(label, n - 1)
    has = label < n
    mn = np.where(has[:, None], nrm[src], 0.0).astype(np.float32)
    mc = np.where(has[:, None], pos[src] + rng.normal(0, 40.0, (n, 3)),
                  0.0).astype(np.float32)
    return pos, nrm, mn, mc, label, mask


def _cols(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, d])) for d in range(3)]


def _label_by_lanes(pos, nrm, mn, mc, label, mask, *, w, inf, signed):
    """#1's design: per tile of ``LABEL_TILE_ROWS`` rows, rows
    [b0 − w, b0 + T + w) staged (x = NaN where masked or outside [0, n),
    label ``inf`` outside); a valid row's 2w slots dealt to
    ``LABEL_TILE_LANES`` lanes (lane l takes slots l, l + L, …), each lane
    keeping its own hop and merge-hook minima, the lanes' minima joined;
    a masked row runs no slot."""
    n, rows = label.shape[0], kernels.LABEL_TILE_ROWS
    lanes = kernels.LABEL_TILE_LANES
    cmag = (lambda x: x) if signed else torch.abs
    nblk = -(-n // rows)
    j = (torch.arange(nblk)[:, None] * rows - w
         + torch.arange(rows + 2 * w)[None])
    jc, inside = j.clamp(0, n - 1), (j >= 0) & (j < n)
    ok = inside & mask[jc]
    x = torch.where(ok, pos[0][jc], NAN)
    y, z = pos[1][jc], pos[2][jc]
    lab = torch.where(inside, label[jc], inf)
    cmn = [torch.where(inside, c[jc], 0.0) for c in mn]
    cmc = [torch.where(inside, c[jc], 0.0) for c in mc]
    a = slice(w, w + rows)
    rx, ry, rz = x[:, a], y[:, a], z[:, a]
    rn = [c[jc][:, a] for c in nrm]
    rmn, rmc = [c[:, a] for c in cmn], [c[:, a] for c in cmc]
    lab0 = lab[:, a]
    has = lab0 < inf
    valid = ~torch.isnan(rx)
    big = torch.full((nblk, rows, lanes), inf, dtype=torch.int32)
    nw_l, best_l = big.clone(), big.clone()
    for slot in range(2 * w):
        o = slot - w if slot < w else slot - w + 1
        s = slice(w + o, w + o + rows)
        dx, dy, dz = rx - x[:, s], ry - y[:, s], rz - z[:, s]
        near = (dx * dx + dy * dy + dz * dz <= EG2) & valid
        cl = lab[:, s]
        m0, m1, m2 = (c[:, s] for c in cmn)
        c0, c1, c2 = (c[:, s] for c in cmc)
        d = torch.abs((rx - c0) * m0 + (ry - c1) * m1 + (rz - c2) * m2)
        c = cmag(rn[0] * m0 + rn[1] * m1 + rn[2] * m2)
        hop = near & (cl < inf) & (d <= TH) & (c >= CTH)
        ex, ey, ez = c0 - rmc[0], c1 - rmc[1], c2 - rmc[2]
        mutual = ((torch.abs(ex * rmn[0] + ey * rmn[1] + ez * rmn[2]) <= TH)
                  & (torch.abs(ex * m0 + ey * m1 + ez * m2) <= TH)
                  & (cmag(rmn[0] * m0 + rmn[1] * m1 + rmn[2] * m2) >= CTH))
        mrg = near & has & (cl < lab0) & mutual
        k = slot % lanes
        nw_l[..., k] = torch.where(hop, torch.minimum(nw_l[..., k], cl),
                                   nw_l[..., k])
        best_l[..., k] = torch.where(mrg, torch.minimum(best_l[..., k], cl),
                                     best_l[..., k])
    nw = torch.minimum(lab0, nw_l.min(-1).values)
    best = best_l.min(-1).values
    return nw.reshape(-1)[:n], best.reshape(-1)[:n]


@pytest.mark.parametrize("w", [1, 16, 48])
@pytest.mark.parametrize("signed", [False, True])
def test_label_lane_split_equals_plain(label_problem, w, signed):
    pos, nrm, mn, mc, label, mask = label_problem
    n = len(label)
    args = (_cols(pos), _cols(nrm), _cols(mn), _cols(mc),
            torch.from_numpy(label), torch.from_numpy(mask))
    got = _label_by_lanes(*args, w=w, inf=n, signed=signed)
    want = label_sweep_reference(*args, w=w, th_thickness=TH,
                                 th_normal_cos=CTH, edge_gate2=EG2,
                                 inf_label=n, signed=signed)
    assert n % kernels.LABEL_TILE_ROWS
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # masked rows keep their label and hook nothing
    assert (want[0][~args[5]] == n).all() and (want[1][~args[5]] == n).all()
    if w > 1:
        assert (want[0] != args[4]).sum() > 100 and (want[1] < n).sum() > 50


@pytest.mark.parametrize("w", [1, 16, 48])
def test_label_lane_split_equals_pallas_kernel(label_problem, w):
    pos, nrm, mn, mc, label, mask = label_problem
    n = len(label)
    cols = [pos[:, 0], pos[:, 1], pos[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            mn[:, 0], mn[:, 1], mn[:, 2], mc[:, 0], mc[:, 1], mc[:, 2]]
    tile = pick_tile(n, 1024)
    slab = make_slab(
        [jnp.asarray(c) for c in cols]
        + [jnp.asarray(label.astype(np.float32)),
           jnp.asarray(mask.astype(np.float32))],
        [-3e7, -3e7, -3e7] + [0.0] * 9 + [float(n), 0.0], w, tile,
    )
    j_new, j_best = jax_label_sweep(
        slab, n, w=w, tile=tile, th_thickness=TH, th_normal_cos=CTH,
        edge_gate2=EG2, inf_label=float(n), interpret=True,
    )
    got = _label_by_lanes(_cols(pos), _cols(nrm), _cols(mn), _cols(mc),
                          torch.from_numpy(label), torch.from_numpy(mask),
                          w=w, inf=n, signed=False)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(j_new).astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(j_best).astype(np.int32))
