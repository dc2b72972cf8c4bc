"""The premises of the redesigned #14 kernel, pinned on the CPU.

``csrc/knn_exact.cu`` (#14) scans with one warp for 64 queries: each
query's list sorted by the (d², index) key, candidates streamed in chunks
of 256, each group of 32 filtered by an FMA form of d² against the
worst's d² as it stood before the group, with a margin (a queue of
bits), then inserted in order by key against the current worst, by a
shift; τ is the largest worst over the warp's 64 valid
queries after each visited tile, and the rank-window test runs only on
a chunk that overlaps the warp's rank windows.  It must equal its plain
version bit for bit.  These tests rebuild the design in plain torch on
the CPU, query block by query block and chunk by chunk, and hold it
against ``knn_exact_reference`` and against the JAX package's Pallas
kernel in interpret mode.  #1's design: tests/test_torch_tile_designs.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.pallas_knn import knn_pallas as jax_pallas
from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.core.morton import morton_argsort
from buildingsegment_tpu_torch.ops.knn import order_key, split_key
from buildingsegment_tpu_torch.ops.pallas_knn import (
    _finish,
    _prepare,
    knn_exact_reference,
)

NAN = float("nan")


def _knn_cloud(case):
    """(positions int32[C, 3], mask bool[C]): "grid", an integer grid of
    extent 12 (many equal d²), Morton-sorted, 2,048 rows; "dry", an
    unsorted cloud with 6% valid rows spread over 2,048, so a ±w_excl
    window holds fewer than k valid rows and seeds run dry (+inf);
    "halved", a random cloud in 1,344 rows (= 64 × 21: the query tile
    halved to 64, the candidate tile to 64); "wide", rows spread over the
    20-bit range with near-duplicates (``_wide_cloud``)."""
    rng = np.random.default_rng(31)
    if case == "grid":
        cap, pts = 2048, rng.integers(0, 12, (1900, 3))
        mask = np.arange(cap) < len(pts)
    elif case == "dry":
        cap = 2048
        mask = rng.random(cap) < 0.06
        pts = rng.integers(0, 4000, (int(mask.sum()), 3))
    elif case == "wide":
        return _wide_cloud(rng, 2048, 1900)
    else:
        cap, pts = 1344, rng.integers(0, 3000, (1300, 3))
        mask = np.arange(cap) < len(pts)
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[mask] = pts
    pos, mask = torch.from_numpy(pos), torch.from_numpy(mask)
    if case != "dry":
        order = morton_argsort(pos, mask)
        pos, mask = pos[order], mask[order]
    return pos, mask


def _wide_cloud(rng, cap, m):
    """m integer rows spread over the whole 20-bit Morton range, a fifth
    of them copies of others moved by up to 3 mm: d² of 1e9–1e12 mm²,
    far past 2^24, so the plain d² and the filter's FMA form round, and
    equal f32 d² of different pairs are common."""
    pts = rng.integers(0, 2**20, (m, 3))
    near = rng.random(m) < 0.2
    pts[near] = np.clip(pts[rng.integers(0, m, int(near.sum()))]
                        + rng.integers(-3, 4, (int(near.sum()), 3)),
                        0, 2**20 - 1)
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:m] = pts
    mask = np.arange(cap) < m
    pos, mask = torch.from_numpy(pos), torch.from_numpy(mask)
    order = morton_argsort(pos, mask)
    return pos[order], mask[order]


def _fma_d2(dx, dy, dz):
    """The filter's d² in csrc/knn_exact.cu, fma(dz, dz, fma(dy, dy,
    dx·dx)) in f32: each product exact in f64, each sum rounded to f32."""
    inner = (dy.double() * dy.double() + (dx * dx).double()).float()
    return (dz.double() * dz.double() + inner.double()).float()


@pytest.mark.parametrize("scale", ["integer", "wide", "fraction"])
def test_knn_filter_margin_keeps_members(scale):
    """The premise of #14's filter: where the plain d² (the plain
    version's operations) is at most a worst wd, the FMA form of the same
    pair is at most wd (1 + 2^-20) + 2^-100, so the filter drops no
    member; the two forms do round apart, so the margin is needed."""
    rng = np.random.default_rng({"integer": 1, "wide": 2, "fraction": 3}[scale])
    m = 400_000
    if scale == "integer":
        v = rng.integers(-4000, 4000, (3, m))
    elif scale == "wide":
        v = rng.integers(-2**21, 2**21, (3, m))
    else:
        v = rng.uniform(-3, 3, (3, m)) * 10.0 ** rng.integers(-20, 7, (1, m))
    dx, dy, dz = (torch.from_numpy(a.astype(np.float32)) for a in v)
    d = dx * dx + dy * dy + dz * dz
    dfma = _fma_d2(dx, dy, dz)
    wdm = d * (1.0 + 2.0 ** -20) + 2.0 ** -100
    assert (dfma <= wdm).all()
    if scale != "integer":  # below 2^24 both forms are exact
        assert (dfma > d).any()


def _knn_by_warps(cols, seed_d, seed_i, visit, visit_d2, counts, *, qt, ct,
                  w_excl):
    """#14's warp design: blocks of ``KNN_TILE_QUERIES`` queries of a query
    tile; each list sorted by key; the listed tiles in chunks of
    min(ct, 256), groups of 32 candidates filtered by the FMA form of d²
    against the worst's d² before the group with the kernel's margin, the
    passing ones inserted in order by a shift where their key is below
    the current worst; τ over the block's valid queries after
    each tile; the rank-window test only on chunks that overlap the
    block's windows.  Returns (d², index) and the number of tiles the
    blocks visited."""
    qb = kernels.KNN_TILE_QUERIES
    n, kk = seed_d.shape
    assert kk <= kernels.KNN_TILE_MAX_KK and qt % qb == 0 and ct % 32 == 0
    px = cols[0]
    valid = px > -1e7
    pk = [torch.where(valid, c, NAN) for c in cols]  # the float4 pack
    chunk = min(ct, kernels.KNN_CHUNK)
    nblk = n // qb
    rows = torch.arange(n).reshape(nblk, qb)
    qtile = rows[:, 0] // qt
    qx, qy, qz = (c[rows] for c in pk)
    qvalid = valid[rows]
    lists = torch.sort(order_key(seed_d, seed_i).reshape(nblk, qb, kk),
                       -1).values
    worst = torch.where(qvalid, lists[..., -1], 0)

    def tau_of():
        wd = split_key(worst.reshape(-1))[0].reshape(nblk, qb)
        return torch.where(qvalid, wd, 0.0).amax(1)

    tau = tau_of()
    alive = torch.ones(nblk, dtype=torch.bool)
    visited = 0
    slot = torch.arange(kk)
    for v in range(int(counts.max())):
        if v > 0:
            alive &= visit_d2[qtile, v] <= tau
        alive &= v < counts[qtile]
        if not alive.any():
            break
        visited += int(alive.sum())
        tile = visit[qtile, v].long()
        for h in range(ct // chunk):
            cb = tile * ct + h * chunk
            win = ((cb <= rows[:, 0] + qb - 1 + w_excl)
                   & (cb + chunk - 1 >= rows[:, 0] - w_excl))
            for g in range(0, chunk, 32):
                c = cb[:, None] + g + torch.arange(32)[None]  # [B, 32]
                dx = qx[:, :, None] - pk[0][c][:, None]
                dy = qy[:, :, None] - pk[1][c][:, None]
                dz = qz[:, :, None] - pk[2][c][:, None]
                d = dx * dx + dy * dy + dz * dz
                cc = c[:, None].expand(-1, qb, -1)
                key = order_key(d, cc)
                # a NaN d² (an invalid candidate) keys above every worst
                key = torch.where(torch.isnan(d), torch.iinfo(torch.int64).max,
                                  key)
                # the filter: the FMA form of d² (products exact in f64)
                # against the worst's d² as it stood, with the margin
                dfma = _fma_d2(dx, dy, dz)
                wd = split_key(worst.reshape(-1))[0].reshape(nblk, qb)
                wdm = wd * (1.0 + 2.0 ** -20) + 2.0 ** -100
                passed = dfma <= wdm[..., None]
                outside = (cc - rows[..., None]).abs() > w_excl
                passed &= torch.where(win[:, None, None], outside, True)
                passed &= alive[:, None, None]
                for j in range(32):
                    b, q = torch.nonzero(passed[..., j], as_tuple=True)
                    x = key[b, q, j]
                    take = x < worst[b, q]
                    b, q, x = b[take], q[take], x[take]
                    if b.numel() == 0:
                        continue
                    lst = lists[b, q]
                    p = (lst < x[:, None]).sum(1, keepdim=True)
                    shifted = torch.cat([lst[:, :1], lst[:, :-1]], 1)
                    new = torch.where(slot < p, lst,
                                      torch.where(slot == p, x[:, None],
                                                  shifted))
                    lists[b, q] = new
                    worst[b, q] = new[:, -1]
        tau = torch.where(alive, tau_of(), tau)
    d, i = split_key(lists.reshape(n, kk))
    return d, i, visited


@pytest.mark.parametrize("case", ["grid", "dry", "halved", "wide"])
@pytest.mark.parametrize("k", [2, 16, 50])
def test_knn_warp_design_equals_plain(case, k):
    pos, mask = _knn_cloud(case)
    cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct, w = _prepare(
        pos, mask, k)
    args = (cols, seed_d, seed_i, visit, visit_d2, counts)
    kw = dict(qt=qt, ct=ct, w_excl=w)
    got_d, got_i, visited = _knn_by_warps(*args, **kw)
    want_d, want_i = knn_exact_reference(*args, **kw)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    # the scan replaced seeds, and the pruning skipped listed tiles
    # somewhere or every tile was needed
    assert not torch.equal(torch.sort(got_i, 1).values,
                           torch.sort(seed_i, 1).values)
    assert visited <= int(counts.sum()) * (qt // kernels.KNN_TILE_QUERIES)
    if case == "dry":
        assert torch.isinf(seed_d[mask]).any()
    if case == "halved":
        assert (qt, ct) == (64, 64)
    if case == "wide":  # d² past 2^24: both forms of d² round
        assert (want_d[mask] > 2**24).float().mean() > 0.5
    if case == "grid" and k > 2:
        # ties in d² are common, so the index order is exercised
        dd = want_d[mask]
        assert (dd[:, 1:] == dd[:, :-1]).sum() > 1000


@pytest.mark.parametrize("case,k", [("grid", 16), ("dry", 16),
                                    ("halved", 50), ("grid", 2)])
def test_knn_warp_design_equals_pallas_kernel(case, k):
    pos, mask = _knn_cloud(case)
    cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct, w = _prepare(
        pos, mask, k)
    got_d, got_i, _ = _knn_by_warps(cols, seed_d, seed_i, visit, visit_d2,
                                    counts, qt=qt, ct=ct, w_excl=w)
    ti, td = _finish(got_d, got_i, mask)
    ji, jd = (np.asarray(a) for a in jax_pallas(
        jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()), k=k,
        query_tile=qt, cand_tile=ct, interpret=True))
    # the JAX kernel orders equal d² its own way: the distances agree slot
    # by slot, the indices as sets below each row's last distance
    td, ti = td.numpy(), ti.numpy()
    np.testing.assert_array_equal(td, jd)
    below = td < td[:, -1:]
    np.testing.assert_array_equal(np.sort(np.where(below, ti, -1), 1),
                                  np.sort(np.where(below, ji, -1), 1))
    m = mask.numpy()
    assert below[m].sum() > min(5, k - 2) * m.sum()
