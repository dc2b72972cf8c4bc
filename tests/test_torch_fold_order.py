"""The summation order the stage-then-fold kernels keep, pinned on the CPU.

``csrc/compact_sweep.cu`` (#2, per-slot stats), ``csrc/segsum.cu``
(#11, payload sums and moments about q; #8, the plain per-id sums) and
``csrc/adopt.cu`` (#13, per-lane sums of the adopted rows, blocks of 256
rows) must equal their plain versions bit for bit.  These tests hold the plain versions against a numpy
float32 oracle of the documented order: block b of 1024 rows adds each
id's rows one after another in row order from +0, then the block tables
are added in block order from +0.  #2's blocks are shifted by the window
half-width w (block b covers rows [b·1024 − w, (b+1)·1024 − w)).
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.ops.compact_sweep import (
    COMPACT_L,
    compact_slot_stats,
)
from buildingsegment_tpu_torch.ops.adopt import (
    adopt_table,
    plane_adopt_reference,
)
from buildingsegment_tpu_torch.ops.segsum import (
    payload_moment_sums_reference,
    plane_sums_reference,
)


def _left_fold_oracle(blk, ids, rows, nblk, size):
    """Each (block, id)'s rows added one after another in row order
    (``np.add.at`` is unbuffered and in index order), then the block
    tables added in block order, all in float32."""
    part = np.zeros((nblk, size, rows.shape[1]), np.float32)
    np.add.at(part, (blk, ids), rows)
    acc = np.zeros((size, rows.shape[1]), np.float32)
    for b in range(nblk):
        acc = acc + part[b]
    return acc


def _ids(case, n, bound, shift, rng):
    """Row ids laid out as the kernels' hard cases: long runs across
    block edges (block 0's edge at 1024 − shift), one id over a whole
    block, and a block with no live row (ids ``bound`` are dead)."""
    ids = rng.integers(0, bound, n)
    if case == "runs":
        ids = np.repeat(rng.integers(0, bound, n // 300 + 1), 300)[:n]
        ids[1024 - shift:2048 - shift] = 3
        ids[3072 - shift:4096 - shift] = bound
    ids[rng.random(n) < 0.1] = bound
    return ids


def _assert_bits(got, want):
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", ["scattered", "runs"])
@pytest.mark.parametrize("signed", [False, True])
def test_compact_slot_stats_left_fold_order(case, signed):
    """#2's per-slot sums over w-shifted blocks, the anchor-pure columns
    included, equal the oracle bit for bit."""
    rng = np.random.default_rng(31)
    n, w, lc, bound, thac = 5000, 16, COMPACT_L, 1500, 0.3
    pos = rng.uniform(0, 3e4, (n, 3)).astype(np.float32)
    cn = rng.normal(size=(n, 3)).astype(np.float32)
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    anchor = rng.normal(size=(lc, 3)).astype(np.float32)
    anchor /= np.linalg.norm(anchor, axis=1, keepdims=True)
    clab = _ids(case, n, bound, w, rng).astype(np.int32)
    clab[clab == bound] = lc  # no label
    clab[rng.random(n) < 0.05] = bound + 7  # a slot at or above the bound

    live = clab < bound
    x, y, z = pos.T
    base = np.stack([np.ones(n, np.float32), cn[:, 0], cn[:, 1], cn[:, 2],
                     x, y, z, x * x + y * y + z * z], 1)
    a = anchor[np.minimum(clab, lc - 1)]
    agree = cn[:, 0] * a[:, 0] + cn[:, 1] * a[:, 1] + cn[:, 2] * a[:, 2]
    pure = (agree if signed else np.abs(agree)) >= np.float32(thac)
    assert 0.2 < pure[live].mean() < 0.8
    rows = np.concatenate([base, np.where(pure[:, None], base, 0)], 1)
    rows = rows.astype(np.float32)
    blk = (np.arange(n) + w) // kernels.COMPACT_STATS_ROWS
    want = _left_fold_oracle(blk[live], clab[live], rows[live],
                             int(blk[-1]) + 1, lc)

    t = torch.from_numpy
    got = compact_slot_stats(
        [t(pos[:, d].copy()) for d in range(3)],
        [t(cn[:, d].copy()) for d in range(3)], t(clab), t(anchor), bound,
        lc=lc, w=w, th_anchor_cos=thac, anchor_gate=True, signed=signed)
    _assert_bits(got.numpy(), want)
    # without the anchor gate the pure columns stay zero
    got = compact_slot_stats(
        [t(pos[:, d].copy()) for d in range(3)],
        [t(cn[:, d].copy()) for d in range(3)], t(clab), t(anchor), bound,
        lc=lc, w=w, th_anchor_cos=thac, anchor_gate=False, signed=signed)
    _assert_bits(got[:, :8].numpy(), want[:, :8])
    assert not got[:, 8:].any()


@pytest.mark.parametrize("case", ["scattered", "runs"])
def test_payload_moment_sums_left_fold_order(case):
    """#11's payload sums and moments about q over 1024-row blocks equal
    the oracle bit for bit; ids below 0 and at or above the live bound
    are dropped, ids at or above the centers' count use center 0."""
    rng = np.random.default_rng(37)
    n, n_live, cap = 5000, 300, 1024
    bound = kernels.ceil128(n_live)  # 384
    ids = _ids(case, n, bound, 0, rng)
    ids[rng.random(n) < 0.05] = -1
    ids = ids.astype(np.int32)
    pos = rng.uniform(0, 3e4, (n, 3)).astype(np.float32)
    cn = rng.normal(size=(n, 3)).astype(np.float32)
    pay = np.concatenate([np.ones((n, 1)), cn, pos, (pos * pos).sum(1)[:, None]],
                         1).astype(np.float32)
    q = rng.uniform(0, 3e4, (n_live, 3)).astype(np.float32)

    live = (ids >= 0) & (ids < bound)
    s = ids[live]
    qs = np.where((s < n_live)[:, None], q[np.minimum(s, n_live - 1)],
                  np.float32(0))
    d = pay[live][:, 4:7] - qs
    mom = np.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
                    d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]],
                   1)
    rows = np.concatenate([pay[live], mom], 1).astype(np.float32)
    blk = np.arange(n)[live] // kernels.PAYMOM_ROWS
    want = _left_fold_oracle(blk, s, rows, -(-n // kernels.PAYMOM_ROWS), bound)

    sums, moments = payload_moment_sums_reference(
        torch.from_numpy(ids), torch.from_numpy(pay), torch.from_numpy(q),
        n_live, table_cap=cap)
    assert sums.shape == (cap, 8) and moments.shape == (cap, 6)
    _assert_bits(sums[:bound].numpy(), want[:, :8])
    _assert_bits(moments[:bound].numpy(), want[:, 8:])
    assert not sums[bound:].any() and not moments[bound:].any()


@pytest.mark.parametrize("case", ["dense_histogram", "sparse_dead"])
@pytest.mark.parametrize("cols", [1, 3, 8, 128])
def test_plane_sums_left_fold_order(case, cols):
    """#8's per-id sums over 1024-row blocks (7,000 rows: the last block
    partial) equal the oracle bit for bit on float payloads: a dense
    histogram (12 ids, the raster's shape), and sparse ids in long runs
    with dead rows (below 0, above the live bound 384, above the table)
    and a block with no live row; ids in [n_live, 384) still count."""
    rng = np.random.default_rng(59 + cols)
    n = 7000
    if case == "dense_histogram":
        n_live, cap = 12, 12
        ids = rng.integers(0, n_live, n)
    else:
        n_live, cap = 300, 1024
        ids = _ids("runs", n, kernels.ceil128(n_live), 0, rng)
        ids[rng.random(n) < 0.03] = n_live + 40  # above n_live, still live
        ids[rng.random(n) < 0.05] = -1
        ids[rng.random(n) < 0.05] = cap + 5
    ids = ids.astype(np.int32)
    bound = kernels.ceil128(n_live)
    pay = rng.uniform(-500, 500, (n, cols)).astype(np.float32)

    live = (ids >= 0) & (ids < bound)
    blk = np.arange(n)[live] // kernels.SEGSUM_ROWS
    want = _left_fold_oracle(blk, ids[live], pay[live],
                             -(-n // kernels.SEGSUM_ROWS), bound)
    got = plane_sums_reference(torch.from_numpy(ids), torch.from_numpy(pay),
                               n_live, table_cap=cap)
    assert got.shape == (kernels.ceil128(cap), cols)
    _assert_bits(got[:bound].numpy(), want)
    assert not got[bound:].any()
    if case == "sparse_dead":
        assert not live.all()


@pytest.mark.parametrize("case", ["scattered", "distinct_lanes"])
def test_plane_adopt_left_fold_order(case):
    """#13's per-lane sums over 256-row blocks equal the oracle bit for
    bit: 128 planes z = 0, 3 m apart along x, reach 1 m, so a hole row on
    plane l adopts lane l and one between two planes adopts nothing;
    lane 7 takes a row of every block, blocks 5 and 6 hold holes and
    adopt nothing, and in "distinct_lanes" block 3 adopts into all 128
    lanes, shuffled."""
    rng = np.random.default_rng(53)
    n, k, blk_rows = 20_000, kernels.ADOPT_LANES, kernels.ADOPT_ROWS
    nblk = -(-n // blk_rows)
    lanes = np.where(rng.random(n) < 0.5, rng.integers(0, k, n), -1)
    holes = np.repeat(rng.random(nblk) < 0.3, blk_rows)[:n]
    holes &= rng.random(n) < 0.7
    if case == "distinct_lanes":
        lanes[3 * blk_rows:4 * blk_rows] = np.concatenate(
            [rng.permutation(k)] * 2)
        holes[3 * blk_rows:4 * blk_rows] = True
    lanes[::blk_rows] = 7
    holes[::blk_rows] = True
    lanes[5 * blk_rows:7 * blk_rows] = -1
    holes[5 * blk_rows:7 * blk_rows] = True
    cx = np.arange(k, dtype=np.float32) * 3000
    x = np.where(lanes >= 0, cx[np.maximum(lanes, 0)],
                 cx[rng.integers(0, k - 1, n)] + 1500)
    pos = np.stack([x + rng.uniform(-300, 300, n), rng.uniform(-300, 300, n),
                    rng.uniform(-50, 50, n)], 1).astype(np.float32)
    nrm = np.array([0, 0, 1]) + rng.normal(size=(n, 3)) * 0.05
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    payload = np.concatenate([np.ones((n, 1)), nrm, pos,
                              (pos * pos).sum(1, keepdims=True)],
                             1).astype(np.float32)
    t = torch.from_numpy
    ck = t(np.stack([cx, np.zeros(k), np.zeros(k)], 1).astype(np.float32))
    table = adopt_table(t(np.tile(np.float32([0, 0, 1]), (k, 1))), ck,
                        torch.zeros(k), (ck * ck).sum(1),
                        torch.full((k,), 1e6), torch.ones(k, dtype=torch.bool))
    rows = t(rng.permutation(4096)[:k].astype(np.int32))
    adopted, row, acc = plane_adopt_reference(
        t(payload), t(holes), table, rows, th_thickness=300.0, th_cos=0.88)

    got = (lanes >= 0) & holes
    np.testing.assert_array_equal(adopted.numpy(), got)
    np.testing.assert_array_equal(row.numpy(),
                                  np.where(got, rows.numpy()[lanes], 0))
    idx = np.nonzero(got)[0]
    want = _left_fold_oracle(idx // blk_rows, lanes[idx], payload[idx],
                             nblk, k)
    _assert_bits(acc.numpy(), want)
    assert int(want[7, 0]) >= nblk - 2
    if case == "distinct_lanes":
        assert (want[:, 0] > 0).all()
