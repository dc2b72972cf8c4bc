"""The fixed-order per-id sums (``ops.segsum.segment_sums``), their
order (``ops.segsum.segment_order_reference`` and the digit plan of the
card's sort, ``kernels.segment_sort_plan``) and the finalize's pair
lookup (``ops.segsum.table_lookup_pair``), on the CPU.

``csrc/segment_sum.cu`` must equal ``segment_sums_reference`` bit for
bit, so the order is pinned here against a numpy float32 oracle: each
id's rows added one after another in row order (``np.add.at`` is
unbuffered and in index order) onto +0, or onto +0 + ``init``; rows
whose id lies outside [0, size) add nothing.  The JAX package computes
these sums with XLA scatter-adds, in no order a test can pin.  The pair
lookup's plain version is held against two calls of the JAX package's
``table_lookup`` Pallas kernel in interpret mode, with disjoint
supports, as the finalize makes them (buildingsegment_tpu/seg/coarse.py
step 4).  A spy checks that the port's six sum call sites take
``segment_sums``.  The order's plain version is held against numpy's
stable argsort over the live rows, and the plan's digit passes, applied
one after another as stable sorts (LSD), against the one stable sort.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.segsum import table_lookup as jax_lookup
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.kernels import (
    SEGMENT_SORT_MAX_DIGIT,
    segment_sort_plan,
)
from buildingsegment_tpu_torch.dist import ShardGroup, sharded_pipeline
from buildingsegment_tpu_torch.ops.segsum import (
    segment_order_reference,
    segment_sums,
    segment_sums_reference,
    table_lookup_pair,
    table_lookup_pair_reference,
)
from buildingsegment_tpu_torch.pipeline import HostPointCloud, segment_cloud
from buildingsegment_tpu_torch.seg import coarse, region_grow
from buildingsegment_tpu_torch.utils import make_building_cloud

TILE = 256


def _oracle(idx, rows, size, init=None):
    """The documented order in numpy float32."""
    out = np.zeros((size, rows.shape[1]), np.float32)
    if init is not None:
        out = out + init  # +0 + init
    live = (idx >= 0) & (idx < size)
    np.add.at(out, idx[live], rows[live])
    return out


def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _ids(case, m, size, rng):
    """Row ids: scattered over the table, or long runs (one id over
    thousands of rows, spanning many 1,024-row blocks, interleaved with
    short ones), a tenth of them dead (negative, or at and above the
    table)."""
    if case == "scattered":
        ids = rng.integers(0, size, m)
    else:
        ids = rng.integers(0, size, m)
        ids[rng.random(m) < 0.6] = 3
        ids[m // 3:m // 3 + 2500] = size - 1
    dead = rng.random(m) < 0.1
    ids[dead] = rng.choice([-1, -7, size, size + 5], int(dead.sum()))
    return ids


@pytest.mark.parametrize("case", ["scattered", "long_runs"])
@pytest.mark.parametrize("cols", [1, 8, 16])
def test_segment_sums_row_order(case, cols):
    """C = 1, 8 and 16, bit for bit against the oracle; ids outside the
    table dropped."""
    rng = np.random.default_rng(cols * 10 + len(case))
    m, size = 9000, 500
    ids = _ids(case, m, size, rng)
    rows = (rng.normal(size=(m, cols)) * 1e3).astype(np.float32)
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), size)
    _assert_bits(got, _oracle(ids, rows, size))
    if case == "long_runs":
        assert (ids == 3).sum() > 3000  # one id over all nine 1,024-row blocks


@pytest.mark.parametrize("cols", [1, 8])
def test_segment_sums_drops_ids_outside(cols):
    """Ids below 0 or at and above ``size`` add nothing, however many rows
    carry them (about a third of the rows here, as a caller's dump id): the
    sums are those of the live rows alone, onto +0 or +0 + init."""
    rng = np.random.default_rng(70 + cols)
    m, size = 4000, 211
    ids = rng.integers(-2, size + 100, m)
    assert ((ids < 0) | (ids >= size)).sum() > m // 4
    rows = rng.normal(size=(m, cols)).astype(np.float32)
    live = (ids >= 0) & (ids < size)
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), size)
    _assert_bits(got, _oracle(ids, rows, size))
    alone = segment_sums(torch.from_numpy(ids[live]),
                         torch.from_numpy(rows[live]), size)
    _assert_bits(got, alone.numpy())
    init = rng.normal(size=(size, cols)).astype(np.float32)
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), size,
                       torch.from_numpy(init))
    _assert_bits(got, _oracle(ids, rows, size, init))


@pytest.mark.parametrize("cols", [1, 16])
def test_segment_sums_continue_from_init(cols):
    """With ``init`` each id's fold starts from +0 + init[id]: an id with
    no rows keeps init (−0 read as +0), and two halves of the rows, the
    second continuing the first, give the whole fold."""
    rng = np.random.default_rng(90 + cols)
    m, size = 6000, 400
    ids = _ids("long_runs", m, size, rng)
    ids[ids == 17] = 18  # id 17 has no rows
    rows = rng.normal(size=(m, cols)).astype(np.float32)
    init = rng.normal(size=(size, cols)).astype(np.float32)
    init[17] = -0.0
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), size,
                       torch.from_numpy(init))
    _assert_bits(got, _oracle(ids, rows, size, init))
    assert got.numpy()[17].view(np.int32).tolist() == [0] * cols
    head = segment_sums(torch.from_numpy(ids[:2500]),
                        torch.from_numpy(rows[:2500]), size)
    tail = segment_sums(torch.from_numpy(ids[2500:]),
                        torch.from_numpy(rows[2500:]), size, head)
    _assert_bits(tail, _oracle(ids, rows, size))


def test_segment_sums_start_from_plus_zero():
    """The fold starts from +0, not from an id's first row: rows of −0
    sum to +0, with and without ``init``."""
    ids = np.array([0, 0, 1, 2, 2, 2], np.int64)
    rows = np.full((6, 2), -0.0, np.float32)
    rows[3] = [1.5, -0.0]
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), 4)
    bits = got.numpy().view(np.int32)
    assert bits[:2].tolist() == [[0, 0], [0, 0]]
    assert got[2].tolist() == [1.5, 0.0] and bits[2, 1] == 0
    init = np.full((4, 2), -0.0, np.float32)
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), 4,
                       torch.from_numpy(init))
    assert not got.numpy().view(np.int32)[[0, 1, 3]].any()


@pytest.mark.parametrize("init", [False, True])
def test_segment_sums_no_rows(init):
    """M = 0, and every row dead: the table is +0 (or +0 + init)."""
    size = 5
    tab = np.arange(size * 3, dtype=np.float32).reshape(size, 3) - 4.0
    tab[0, 0] = -0.0
    it = torch.from_numpy(tab) if init else None
    empty = segment_sums(torch.zeros(0, dtype=torch.int64),
                         torch.zeros((0, 3)), size, it)
    dead = segment_sums(torch.tensor([5, -1, 9]), torch.ones((3, 3)), size,
                        it)
    want = _oracle(np.zeros(0, np.int64), np.zeros((0, 3), np.float32), size,
                   tab if init else None)
    _assert_bits(empty, want)
    _assert_bits(dead, want)


def test_segment_sums_size_one_and_large_ids():
    """``size`` = 1, and a table above 2^21 ids with few rows (ids near
    its end): no id limit below the table."""
    got = segment_sums(torch.tensor([0, 0, 1]),
                       torch.tensor([[1.0], [2.0], [4.0]]), 1)
    assert got.tolist() == [[3.0]]
    size = (1 << 21) + 3000
    rng = np.random.default_rng(5)
    ids = np.concatenate([rng.integers(size - 40, size, 300),
                          [0, 1 << 21, size]])
    rows = rng.normal(size=(ids.shape[0], 1)).astype(np.float32)
    got = segment_sums(torch.from_numpy(ids), torch.from_numpy(rows), size)
    _assert_bits(got, _oracle(ids, rows, size))
    assert got[size - 40:].abs().sum() > 0


def test_segment_sums_reference_is_the_cpu_path():
    """On the CPU ``segment_sums`` is its plain version; int32 ids give
    the int64 ids' sums."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 60, 700)
    rows = torch.from_numpy(rng.normal(size=(700, 4)).astype(np.float32))
    a = segment_sums(torch.from_numpy(ids), rows, 50)
    b = segment_sums_reference(torch.from_numpy(ids).int(), rows, 50)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _order_oracle(idx, size):
    """(perm, start, end) in numpy: the live rows by numpy's stable
    argsort, each id's run from its count; [-1, -1) where it has none."""
    live = np.flatnonzero((idx >= 0) & (idx < size))
    perm = live[np.argsort(idx[live], kind="stable")]
    count = np.bincount(idx[live], minlength=size)
    end = np.cumsum(count)
    start = end - count
    start[count == 0] = -1
    end[count == 0] = -1
    return perm, start, end


def _order_ids(case, rng):
    """(ids, size) of one order case."""
    if case in ("scattered", "long_runs"):
        return _ids(case, 9000, 500, rng), 500
    if case == "outside":  # a third of the rows below 0 or at/above size
        return rng.integers(-40, 260, 3000), 211
    if case == "no_rows":
        return np.zeros(0, np.int64), 7
    if case == "all_dead":
        return rng.choice([-1, -9, 7, 100], 500), 7
    return np.arange(4000)[::-1].copy(), 4000  # one id for every row


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("case", ["scattered", "long_runs", "outside",
                                  "no_rows", "all_dead", "one_each"])
def test_segment_order_reference_matches_numpy(case, dtype):
    """The order's plain version: the live rows stably by id (numpy's
    stable argsort), each id's run bounds, [-1, -1) for an id without
    rows; ids below 0 and at or above ``size`` get no slot; int32 ids
    give the int64 ids' order."""
    ids, size = _order_ids(case, np.random.default_rng(len(case)))
    got = segment_order_reference(torch.from_numpy(ids.astype(dtype)), size)
    want = _order_oracle(ids, size)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    perm, start, end = (g.numpy() for g in got)
    for s in np.flatnonzero(start >= 0)[:50]:  # a run holds its id's rows
        rows = perm[start[s]:end[s]]
        assert (ids[rows] == s).all() and (np.diff(rows) > 0).all()


# size → (key bits, passes, digit bits): around each pass boundary (2^11,
# 2^22), the tables of the main path (4,096 planes, the default path's
# deepest level, brute, config 5, the slice) and the largest size
_PLANS = {
    1: (0, 1, 0), 2: (1, 1, 1), 3: (2, 1, 2), 1023: (10, 1, 10),
    1024: (10, 1, 10), 1025: (11, 1, 11), 2047: (11, 1, 11),
    2048: (11, 1, 11), 2049: (12, 2, 6), 4095: (12, 2, 6),
    4096: (12, 2, 6), 4097: (13, 2, 7), 13952: (14, 2, 7),
    61440: (16, 2, 8), 73728: (17, 2, 9), 223232: (18, 2, 9),
    (1 << 22) - 1: (22, 2, 11), 1 << 22: (22, 2, 11),
    (1 << 22) + 1: (23, 3, 8), (1 << 31) - 2: (31, 3, 11),
}


@pytest.mark.parametrize("size", sorted(_PLANS))
def test_segment_sort_plan(size):
    """The card sort's digit plan: the bits of the largest id, ``size −
    1``, in the fewest passes of at most 11 bits, split evenly."""
    bits, passes, digit = segment_sort_plan(size)
    assert (bits, passes, digit) == _PLANS[size]
    assert bits == (size - 1).bit_length() and (size - 1) >> bits == 0
    assert digit <= SEGMENT_SORT_MAX_DIGIT and passes * digit >= bits
    assert passes == 1 or (passes - 1) * SEGMENT_SORT_MAX_DIGIT < bits


@pytest.mark.parametrize("size", [2, 2048, 2049, 13952, 223232,
                                  (1 << 22) + 1])
def test_segment_sort_plan_lsd_is_the_stable_order(size):
    """The plan's digit passes, each a stable sort by its digit from the
    lowest up (what the card sort's passes compute), give the one stable
    sort of the live rows: no id bit is left out, at one, two and three
    passes."""
    rng = np.random.default_rng(size % 1000)
    ids = rng.integers(-3, size + 3, 6000)
    ids[:2000] = rng.integers(0, min(size, 64), 2000)  # many equal ids
    ids[-1] = size - 1
    _bits, passes, digit = segment_sort_plan(size)
    order = np.flatnonzero((ids >= 0) & (ids < size))
    for p in range(passes):
        d = (ids[order] >> (p * digit)) & ((1 << digit) - 1)
        order = order[np.argsort(d, kind="stable")]
    np.testing.assert_array_equal(order, _order_oracle(ids, size)[0])


@pytest.mark.parametrize("n_live", [0, 130, 300, 600])
def test_table_lookup_pair_matches_two_jax_lookups(n_live):
    """The pair lookup's plain version against two calls of the JAX
    package's ``table_lookup`` (Pallas, interpret mode), the members'
    ids and the adopted holes' ids on disjoint rows, as in the
    finalize; ids above the live bound and above the tables read 0."""
    rng = np.random.default_rng(11 + n_live)
    n, cap = 5000, 650
    member = rng.random(n) < 0.6
    ids_a = np.where(member, rng.integers(1, 700, n), 0).astype(np.int32)
    ids_b = np.where(~member & (rng.random(n) < 0.5),
                     rng.integers(1, 700, n), 0).astype(np.int32)
    lut_a = rng.integers(0, 300, cap).astype(np.int32)
    lut_b = rng.integers(0, 300, cap - 1).astype(np.int32)
    lut_a[0] = lut_b[0] = 0
    want = sum(
        np.asarray(jax_lookup(jnp.asarray(i), jnp.asarray(t.astype(
            np.float32)), jnp.int32(n_live), tile=TILE, interpret=True))
        .astype(np.int32)
        for i, t in ((ids_a, lut_a), (ids_b, lut_b)))
    args = [torch.from_numpy(x) for x in (ids_a, lut_a, ids_b, lut_b)]
    got = table_lookup_pair(*args, n_live)
    assert torch.equal(got, table_lookup_pair_reference(*args, n_live))
    np.testing.assert_array_equal(got.numpy(), want)
    if n_live:
        assert got.abs().sum() > 0


def _spy(monkeypatch):
    """Record the calling function of every ``segment_sums`` call made
    from region_grow and coarse."""
    seen = []

    def spy(*args, **kw):
        seen.append(sys._getframe(1).f_code.co_name)
        return segment_sums(*args, **kw)
    monkeypatch.setattr(region_grow, "segment_sums", spy)
    monkeypatch.setattr(coarse, "segment_sums", spy)
    return seen


def test_sum_call_sites_take_segment_sums(monkeypatch):
    """The six call sites: the window path's ``fold_sums`` alone and
    through a shard group (``ShardGroup.fold`` calls its lambda), the
    graph solve's ``label_models`` and ``global_merge``, and the
    finalize's ``_merge_coplanar`` and ``_adopt_holes``."""
    seen = _spy(monkeypatch)
    pts, _ = make_building_cloud(seed=5, spacing_mm=200.0, width_mm=5000.0,
                                 depth_mm=4000.0, wall_h_mm=3000.0,
                                 ridge_h_mm=4000.0)
    segment_cloud(HostPointCloud(positions=pts),
                  PipelineConfig(knn_method="window"), device="cpu")
    segment_cloud(HostPointCloud(positions=pts),
                  PipelineConfig(knn_method="brute"), device="cpu")
    cfg = PipelineConfig(normal_radius=1e6, pad_to_multiple=1024)
    cap = cfg.padded_count(len(pts))
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    sharded_pipeline(ShardGroup(None, 0, 1, "gloo", "cpu"), cfg)(
        torch.from_numpy(pos), torch.from_numpy(mask))
    assert {"fold_sums", "<lambda>", "label_models", "global_merge",
            "_merge_coplanar", "_adopt_holes"} <= set(seen), sorted(set(seen))
