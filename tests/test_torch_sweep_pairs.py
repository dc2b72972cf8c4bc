"""The premises of the tiled window sweeps, pinned on the CPU.

``csrc/seed_sweep.cu`` (#4) tests each unordered pair {i, i + d} of a
tile once, from shared memory, and ``csrc/refine_sweep.cu`` (#6) stages
each row's kept plane id and its plane once and lets a group of lanes
split a hole row's candidates.  Both must equal their plain versions bit for
bit.  These tests rebuild each design in plain torch on the CPU, tile by
tile at the kernels' tile sizes, and hold it against
``seed_sweep_reference`` and ``refine_sweep_reference``, which
``tests/test_torch_multigrid_ops.py`` holds against the JAX package's
Pallas kernels.
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu_torch.ops.window_sweep import (
    refine_sweep_reference,
    seed_sweep_reference,
)
from buildingsegment_tpu_torch.utils import make_building_cloud

TH, CTH, EG2 = 300.0, 0.88, 600.0 ** 2
# the refine gates on the sparse cloud, whose rows lie ~700 mm apart with
# random normals: wide enough that hole rows adopt
SPARSE_GATES = dict(th=2000.0, cth=0.3, eg2=2500.0 ** 2)
BIG = torch.iinfo(torch.int32).max


@pytest.fixture(scope="module")
def scene():
    """A small house, Morton-sorted: positions, normals, mask, seed ball.
    8,092 rows (not a multiple of either tile), the padding masked at the
    end, and a masked run across the tile edge at row 2,048."""
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=160.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    cap = 8192
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos),
                                 torch.from_numpy(mask), True)
    spos = spos.float()[:8092].contiguous()
    smask = smask[:8092].clone()
    smask[2048 - 40:2048 + 30] = False
    dk, nrm, _ = knn_normals_window_stats(spos, smask, 15, window=48,
                                          radius=300.0, max_nn=50)
    return spos, nrm, smask, dk


def _sparse_cloud():
    """A cloud at building span (unsorted), 7,000 rows, 30% valid, rows
    1,024–1,919 (whole tiles of both kernels) and the last 300 masked;
    random unit normals and seed balls."""
    rng = np.random.default_rng(21)
    n = 7000
    pos = rng.integers(0, 9000, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.3
    mask[1024:1920] = False
    mask[-300:] = False
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dk = rng.uniform(1e5, 4e7, n).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (pos, nrm, mask, dk))


def _inputs(case, scene):
    if case == "scene":
        return scene
    return _sparse_cloud()


def _cols(t):
    return tuple(t[:, d].contiguous() for d in range(3))


def _staged(n, rows, w):
    """Each tile's staged rows [b0 − w, b0 + rows + w): their row index
    clamped into [0, n) and whether they lie inside it, [tiles, span]."""
    nblk = -(-n // rows)
    j = (torch.arange(nblk)[:, None] * rows - w
         + torch.arange(rows + 2 * w)[None])
    return j.clamp(0, n - 1), (j >= 0) & (j < n)


def _seed_by_pairs(pos, nrm, mask, dk, *, w, signed):
    """#4's design: per tile, rows staged with x = NaN where invalid or
    outside [0, n); each unordered pair {i, i + d} with i in the tile
    tested once for both ends (d² and the cos once); the pairs from the
    left halo tested for their right end alone."""
    n, rows = mask.shape[0], kernels.SEED_TILE_ROWS
    cmag = (lambda x: x) if signed else torch.abs
    jc, inside = _staged(n, rows, w)
    ok = inside & mask[jc]
    nan = torch.tensor(float("nan"))
    x = torch.where(ok, pos[jc, 0], nan)
    y, z, ball = pos[jc, 1], pos[jc, 2], dk[jc]
    ux, uy, uz = (torch.where(ok, nrm[jc, d], 0.0) for d in range(3))
    fail = torch.zeros((jc.shape[0], rows), dtype=torch.bool)
    a = slice(w, w + rows)
    for d in range(1, w + 1):
        b = slice(w + d, w + rows + d)
        dx, dy, dz = x[:, b] - x[:, a], y[:, b] - y[:, a], z[:, b] - z[:, a]
        d2 = dx * dx + dy * dy + dz * dz
        cos_ok = cmag(ux[:, b] * ux[:, a] + uy[:, b] * uy[:, a]
                      + uz[:, b] * uz[:, a]) >= CTH
        pa = torch.abs(dx * ux[:, a] + dy * uy[:, a] + dz * uz[:, a])
        pb = torch.abs(dx * ux[:, b] + dy * uy[:, b] + dz * uz[:, b])
        fail |= (d2 <= ball[:, a]) & ~((pa <= TH) & cos_ok)
        fb = (d2 <= ball[:, b]) & ~((pb <= TH) & cos_ok)
        fail[:, d:] |= fb[:, : rows - d]  # the block's rows only
        # the left halo: block rows r < d against candidate r − d
        k = min(d, rows)
        r, c = slice(w, w + k), slice(w - d, w - d + k)
        dx, dy, dz = x[:, c] - x[:, r], y[:, c] - y[:, r], z[:, c] - z[:, r]
        d2 = dx * dx + dy * dy + dz * dz
        pd = torch.abs(dx * ux[:, r] + dy * uy[:, r] + dz * uz[:, r])
        pc = cmag(ux[:, c] * ux[:, r] + uy[:, c] * uy[:, r]
                  + uz[:, c] * uz[:, r])
        fail[:, :k] |= (d2 <= ball[:, r]) & ~((pd <= TH) & (pc >= CTH))
    return (ok[:, a] & ~fail).reshape(-1)[:n]


@pytest.mark.parametrize("case", ["scene", "sparse"])
@pytest.mark.parametrize("w", [1, 16, 48])
@pytest.mark.parametrize("signed", [False, True])
def test_seed_unordered_pairs_equal_plain(scene, case, w, signed):
    pos, nrm, mask, dk = _inputs(case, scene)
    got = _seed_by_pairs(pos, nrm, mask, dk, w=w, signed=signed)
    want = seed_sweep_reference(_cols(pos), _cols(nrm), mask, dk, w=w,
                                th_thickness=TH, th_normal_cos=CTH,
                                signed=signed)
    assert mask.shape[0] % kernels.SEED_TILE_ROWS
    assert torch.equal(got, want)
    if w > 1:
        assert want.sum() > 50 and (mask & ~want).sum() > 50


def _plane_problem(pos, nrm, mask, case, seed):
    """Plane ids by row blocks (30% dropped) and their fitted [P, 4]
    table, P = 256.  "below": n_live = 9, so the live table is the first
    128 rows, and some rows carry id 200, past it (a zero model); "at":
    ids up to 200 and n_live = 200, so the live table is all P rows."""
    rng = np.random.default_rng(seed)
    n, p = mask.shape[0], 256
    top = 9 if case == "below" else 200
    pid = (np.arange(n) // 60 % top + 1).astype(np.int32)
    if case == "below":
        pid[rng.random(n) < 0.05] = 200
    pid[(rng.random(n) < 0.3) | ~mask.numpy()] = 0
    cn = canonicalize_normals(nrm).numpy()
    posn = pos.numpy()
    tab = np.zeros((p, 4), np.float32)
    for i in np.unique(pid[pid > 0]):
        sel = pid == i
        v = cn[sel].sum(0)
        nv = (v / max(np.linalg.norm(v), 1e-9)).astype(np.float32)
        tab[i - 1, :3] = nv
        tab[i - 1, 3] = np.dot(nv, posn[sel].mean(0).astype(np.float32))
    return torch.from_numpy(pid), torch.from_numpy(tab), top


def _refine_by_lanes(pos, nrm, mask, pid, table, n_live, *, w, th, cth, eg2,
                     clean, adopt, signed, perm):
    """#6's design: per tile, each staged row's eff computed once from its
    own normal and the table (−1 where invalid or outside [0, n)), and
    the model of eff's plane staged beside it; kept, invalid and
    non-adopting rows take their eff; a hole row's 2w candidates, in the
    order ``perm``, are dealt to the group's lanes (lane l of G takes the
    l-th, (l + G)-th, … of them), each lane keeps its own min, and the
    lanes' minima are joined."""
    n, rows = mask.shape[0], kernels.REFINE_TILE_ROWS
    cmag = (lambda x: x) if signed else torch.abs
    ntab = min(kernels.ceil128(n_live), table.shape[0])
    lanes = kernels.REFINE_TILE_GROUP
    tabz = torch.cat([torch.zeros((1, 4)), table[:ntab]])

    def accepts(m, x, y, z, ux, uy, uz):
        d = torch.abs(x * m[..., 0] + y * m[..., 1] + z * m[..., 2]
                      - m[..., 3])
        c = cmag(ux * m[..., 0] + uy * m[..., 1] + uz * m[..., 2])
        return (d <= th) & (c >= cth)

    jc, inside = _staged(n, rows, w)
    valid = inside & mask[jc]
    x, y, z = (pos[jc, d] for d in range(3))
    e = torch.where(valid & (pid[jc] > 0), pid[jc], 0)
    plane = tabz[torch.where(e <= ntab, e, 0).long()]
    if clean:
        e = torch.where(accepts(plane, x, y, z,
                                *(nrm[jc, d] for d in range(3))), e, 0)
    eff = torch.where(valid, e, -1)
    keep = eff[:, w:w + rows]
    out = keep.clamp(min=0).clone()
    if adopt:
        tile, t = torch.nonzero(keep == 0, as_tuple=True)
        row = tile * rows + t
        hold = row < n
        tile, t, row = tile[hold], t[hold], row[hold]
        s0 = t + w
        offs = torch.cat([torch.arange(-w, 0), torch.arange(1, w + 1)])[perm]
        best = torch.full((row.shape[0], lanes), BIG, dtype=torch.int32)
        for k, o in enumerate(offs.tolist()):
            s = s0 + o
            cp = eff[tile, s]
            dx = x[tile, s0] - x[tile, s]
            dy = y[tile, s0] - y[tile, s]
            dz = z[tile, s0] - z[tile, s]
            gate = dx * dx + dy * dy + dz * dz <= eg2
            ok = (cp > 0) & gate & accepts(
                plane[tile, s], x[tile, s0], y[tile, s0], z[tile, s0],
                *(nrm[row, d] for d in range(3)))
            lane = best[:, k % lanes]
            best[:, k % lanes] = torch.where(ok, torch.minimum(lane, cp),
                                             lane)
        m = best.min(1).values
        out[tile, t] = torch.where(m < BIG, m, 0).to(out.dtype)
    return out.reshape(-1)[:n]


@pytest.mark.parametrize("case,table_case", [
    ("scene", "below"), ("scene", "at"), ("sparse", "below"),
    ("sparse", "at"),
])
@pytest.mark.parametrize("clean,adopt", [(True, True), (False, True),
                                         (True, False)])
@pytest.mark.parametrize("w", [16, 48])
def test_refine_lane_split_equals_plain(scene, case, table_case, clean,
                                        adopt, w):
    pos, nrm, mask, _dk = _inputs(case, scene)
    pid, table, n_live = _plane_problem(pos, nrm, mask, table_case, 3)
    g = (SPARSE_GATES if case == "sparse"
         else dict(th=TH, cth=CTH, eg2=EG2))
    perm = torch.randperm(2 * w, generator=torch.Generator().manual_seed(7))
    got = _refine_by_lanes(pos, nrm, mask, pid, table, n_live, w=w, **g,
                           clean=clean, adopt=adopt, signed=False, perm=perm)
    want = refine_sweep_reference(
        _cols(pos), _cols(nrm), mask, pid, table, n_live, w=w,
        th_thickness=g["th"], th_normal_cos=g["cth"], edge_gate2=g["eg2"],
        clean=clean, adopt=adopt)
    assert mask.shape[0] % kernels.REFINE_TILE_ROWS
    assert torch.equal(got, want)
    if adopt:
        assert ((pid == 0) & mask & (want > 0)).sum() > 20
