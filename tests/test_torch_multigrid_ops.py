"""The plain versions of the multigrid path's kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

  * seed rule (#4 ``_seed_kernel_sym``, #5 ``_seed_kernel``) and refine
    sweep (#6 ``_refine_table_kernel_pair``, #7 ``_refine_table_kernel``):
    exact min/or chains over the same f32 operations — bit for bit;
  * lookup (#9 ``_lookup_kernel``): a gather — exact, including the live
    bound rounded up to 128 ids;
  * column lookup (#10 ``_lookup_cols_kernel``, no caller in either
    package): a gather of up to 8 columns, column-major — bit for bit;
  * payload sums + moments (#11 ``_paymom_kernel``): the same products,
    summed in another order — the count column exact, the sums within
    1e-5 and the moments within 1e-4 of the largest entry (the JAX
    package's own tolerance, tests/test_segsum.py);
  * hole adoption (#13 ``_adopt_kernel``): the TPU kernel forms the three
    dot products in one matmul, the port writes each out, so rows at a
    gate boundary may flip — at most 0.1% of the rows differ, the chosen
    rows agree wherever both adopt, and the lane sums agree within
    1e-5 of the largest entry.

Inputs are made with numpy from a seed; the kernels run at tile 256.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.ops.adopt import pack_adopt_tables
from buildingsegment_tpu.ops.adopt import plane_adopt as jax_plane_adopt
from buildingsegment_tpu.ops.segsum import (
    plane_payload_moment_sums as jax_paymom,
    table_lookup as jax_lookup,
    table_lookup_cols as jax_lookup_cols,
)
from buildingsegment_tpu.ops.window_sweep import (
    build_plane_table,
    make_dyn_row,
    make_slab,
    make_spine,
    refine_table_sweep,
    refine_table_sweep_pair,
    seed_sweep as jax_seed_slab,
    seed_sweep_pair,
)
from buildingsegment_tpu.seg.region_grow import window_seeds as jax_seeds
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.adopt import adopt_table, plane_adopt
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.segsum import (
    plane_payload_moment_sums,
    table_lookup,
    table_lookup_cols,
)
from buildingsegment_tpu_torch.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu_torch.ops.window_sweep import (
    refine_sweep,
    seed_sweep,
)
from buildingsegment_tpu_torch.seg.region_grow import window_seeds

TH, CTH, W, TILE = 300.0, 0.88, 16, 256


@pytest.fixture(scope="module")
def scene():
    """Sorted positions, normals, mask and seed ball of a small house."""
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=160.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    cap = 8192
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    spos = np.array(spos, np.float32)
    smask = np.array(smask)
    dk, nrm, _ = knn_normals_window_stats(
        torch.from_numpy(spos), torch.from_numpy(smask), 15, window=48,
        radius=300.0, max_nn=50,
    )
    return spos, nrm.numpy(), smask, dk.numpy()


def _cols(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return tuple(t[:, d].contiguous() for d in range(a.shape[1]))


def _jcols(a):
    return tuple(jnp.asarray(a[:, d]) for d in range(a.shape[1]))


@pytest.mark.parametrize("signed", [False, True])
def test_seed_plain_matches_sym_kernel(scene, signed):
    pos, nrm, mask, dk = scene
    spine = make_spine(_jcols(pos), _jcols(nrm),
                       jnp.asarray(mask.astype(np.float32)), W, TILE)
    dyn = make_dyn_row(jnp.asarray(dk), 0.0, W, TILE)
    bad = seed_sweep_pair(spine, dyn, mask.shape[0], w=W, tile=TILE,
                          th_thickness=TH, th_normal_cos=CTH, signed=signed,
                          interpret=True, sym=True)
    want = mask & (np.asarray(bad) < 0.5)
    got = seed_sweep(_cols(pos), _cols(nrm), torch.from_numpy(mask),
                     torch.from_numpy(dk), w=W, th_thickness=TH,
                     th_normal_cos=CTH, signed=signed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100 and (mask & ~want).sum() > 100


def test_seed_plain_matches_slab_kernel(scene):
    """The one-slab seed kernel (#5) computes the same function."""
    pos, nrm, mask, dk = scene
    slab = make_slab(
        list(_jcols(pos)) + list(_jcols(nrm))
        + [jnp.asarray(dk), jnp.asarray(mask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0, 0.0, 0.0, 0.0, 0.0], W, TILE, rows_out=8,
    )
    bad = jax_seed_slab(slab, mask.shape[0], w=W, tile=TILE,
                        th_thickness=TH, th_normal_cos=CTH, interpret=True)
    got = seed_sweep(_cols(pos), _cols(nrm), torch.from_numpy(mask),
                     torch.from_numpy(dk), w=W, th_thickness=TH,
                     th_normal_cos=CTH)
    np.testing.assert_array_equal(got.numpy(),
                                  mask & (np.asarray(bad) < 0.5))


def test_window_seeds_matches_jax(scene):
    pos, nrm, mask, dk = scene
    want = jax_seeds(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(mask),
                     jnp.asarray(dk), window=W)
    got = window_seeds(torch.from_numpy(pos), torch.from_numpy(nrm),
                       torch.from_numpy(mask), torch.from_numpy(dk),
                       window=W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _plane_problem(pos, nrm, mask, seed):
    """Plane ids by row blocks (some dropped) and their fitted models, in
    the JAX package's [C, 8, 128] table and the port's [P, 4] rows."""
    rng = np.random.default_rng(seed)
    n = mask.shape[0]
    pid = (np.arange(n) // 200 % 9 + 1).astype(np.int32)
    pid[(rng.uniform(size=n) < 0.3) | ~mask] = 0
    p = 256
    cn = canonicalize_normals(torch.from_numpy(nrm)).numpy()
    pn = np.zeros((p, 3), np.float32)
    pc = np.zeros((p, 3), np.float32)
    for i in range(1, 10):
        sel = pid == i
        v = cn[sel].sum(0)
        pn[i - 1] = v / np.linalg.norm(v)
        pc[i - 1] = pos[sel].mean(0)
    jtab = build_plane_table(jnp.asarray(pn), jnp.asarray(pc))
    # the port's rows take the JAX table's offsets b = n·c as they are
    tab = np.asarray(jtab).transpose(1, 0, 2).reshape(8, -1)[:4, :p].T
    return pid, jtab, np.ascontiguousarray(tab)


@pytest.mark.parametrize("clean", [True, False])
def test_refine_plain_matches_pair_kernel(scene, clean):
    pos, nrm, mask, _ = scene
    pid, jtab, tab = _plane_problem(pos, nrm, mask, 1)
    spine = make_spine(_jcols(pos), _jcols(nrm),
                       jnp.asarray(mask.astype(np.float32)), W, TILE)
    dyn = make_dyn_row(jnp.asarray(pid.astype(np.float32)), 0.0, W, TILE)
    kw = dict(w=W, th_thickness=TH, th_normal_cos=CTH, edge_gate2=600.0**2)
    want = refine_table_sweep_pair(
        spine, dyn, mask.shape[0], jtab, jnp.int32(9), tile=TILE,
        big_pid=4097.0, clean=clean, interpret=True, **kw,
    )
    got = refine_sweep(_cols(pos), _cols(nrm), torch.from_numpy(mask),
                       torch.from_numpy(pid), torch.from_numpy(tab), 9,
                       clean=clean, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert (got.numpy() != pid).sum() > 20


def test_refine_plain_matches_slab_kernel(scene):
    """The one-slab refine kernel (#7) computes the same function."""
    pos, nrm, mask, _ = scene
    pid, jtab, tab = _plane_problem(pos, nrm, mask, 2)
    slab = make_slab(
        list(_jcols(pos)) + list(_jcols(nrm))
        + [jnp.asarray(pid.astype(np.float32)),
           jnp.asarray(mask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0, 0.0, 0.0, 0.0, 0.0], W, TILE, rows_out=8,
    )
    kw = dict(w=W, th_thickness=TH, th_normal_cos=CTH, edge_gate2=600.0**2)
    want = refine_table_sweep(slab, mask.shape[0], jtab, jnp.int32(9),
                              tile=TILE, big_pid=4097.0, clean=True,
                              interpret=True, **kw)
    got = refine_sweep(_cols(pos), _cols(nrm), torch.from_numpy(mask),
                       torch.from_numpy(pid), torch.from_numpy(tab), 9,
                       clean=True, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))


def test_lookup_plain_matches_kernel():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 700, size=5000).astype(np.int32)
    lut = rng.integers(0, 300, size=650).astype(np.int32)
    for n_live in (130, 300, 650):
        want = jax_lookup(jnp.asarray(ids), jnp.asarray(lut.astype(np.float32)),
                          jnp.int32(n_live), tile=TILE, interpret=True)
        got = table_lookup(torch.from_numpy(ids), torch.from_numpy(lut),
                           n_live)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int32))
    # the live bound rounds up to 128 ids: 300 live → ids up to 383 read
    got = table_lookup(torch.from_numpy(ids), torch.from_numpy(lut), 300)
    ids_t = torch.from_numpy(ids)
    assert int(got[ids_t >= 384].abs().sum()) == 0
    assert torch.equal(got[ids_t < 384], torch.from_numpy(lut)[ids_t[ids_t < 384].long()])


@pytest.mark.parametrize("cols", [3, 8])
def test_lookup_cols_plain_matches_kernel(cols):
    """#10: ids below 0, inside the live bound, above n_live inside its
    last 128-id chunk, above the bound and above the table; 5,001 rows
    (no multiple of 128); bit for bit, −0.0 in the table read as +0.0."""
    rng = np.random.default_rng(40 + cols)
    n, cap = 5001, 650
    ids = rng.integers(-2, 800, size=n).astype(np.int32)
    lut = rng.normal(size=(cap, cols)).astype(np.float32)
    lut[7] = -0.0
    ids[:4] = 7
    for n_live in (0, 130, 300, cap):
        want = np.asarray(jax_lookup_cols(
            jnp.asarray(ids), jnp.asarray(lut), jnp.int32(n_live),
            tile=TILE, interpret=True))
        got = table_lookup_cols(torch.from_numpy(ids), torch.from_numpy(lut),
                                n_live)
        assert got.shape == (cols, n)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    # 300 live → ids up to 383 read the table, the rest read 0
    got = table_lookup_cols(torch.from_numpy(ids), torch.from_numpy(lut), 300)
    live = (ids >= 0) & (ids < 384)
    np.testing.assert_array_equal(got.numpy()[:, ~live], 0.0)
    np.testing.assert_array_equal(got.numpy()[:, live], lut[ids[live]].T)


def test_paymom_plain_matches_kernel():
    rng = np.random.default_rng(21)
    n, p = 5000, 300
    ids = rng.integers(0, p, n).astype(np.int32)
    ids[::7] = 1024  # excluded rows (at or above the live bound)
    pos = rng.uniform(0, 3e4, (n, 3)).astype(np.float32)
    cn = rng.normal(size=(n, 3)).astype(np.float32)
    pay = np.concatenate(
        [np.ones((n, 1)), cn, pos, (pos * pos).sum(1)[:, None]], 1
    ).astype(np.float32)
    q = rng.uniform(0, 3e4, (1024, 3)).astype(np.float32)
    ja, jm = jax_paymom(jnp.asarray(ids), jnp.asarray(pay), jnp.asarray(q),
                        jnp.int32(p), table_cap=1024, tile=TILE,
                        interpret=True)
    ja, jm = np.asarray(ja), np.asarray(jm)
    a, m = plane_payload_moment_sums(
        torch.from_numpy(ids), torch.from_numpy(pay), torch.from_numpy(q), p,
        table_cap=1024,
    )
    a, m = a.numpy(), m.numpy()
    np.testing.assert_array_equal(a[:, 0], ja[:, 0])
    assert np.abs(a - ja).max() / np.abs(ja).max() < 1e-5
    assert np.abs(m - jm).max() / np.abs(jm).max() < 1e-4


@pytest.mark.parametrize("signed", [False, True])
def test_adopt_plain_matches_kernel(signed):
    rng = np.random.default_rng(0)
    n, k = 3000, 96
    nk = rng.normal(size=(k, 3)).astype(np.float32)
    nk /= np.linalg.norm(nk, axis=1, keepdims=True)
    ck = rng.uniform(0, 30_000, size=(k, 3)).astype(np.float32)
    bk = np.sum(nk * ck, 1)
    ccdk = np.sum(ck * ck, 1)
    reach2 = rng.uniform(500, 4000, size=k).astype(np.float32) ** 2
    lane_ok = rng.uniform(size=k) < 0.8
    rows = rng.permutation(1024)[:k].astype(np.int32)
    t = rng.integers(0, k, size=n)
    along = rng.normal(size=(n, 3)).astype(np.float32) * 800
    pos = ck[t] + along - np.sum(along * nk[t], 1, keepdims=True) * nk[t]
    pos = (pos + rng.normal(size=n)[:, None] * 250 * nk[t]).astype(np.float32)
    cn = nk[t] + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    holes = rng.uniform(size=n) < 0.6
    pay = np.concatenate(
        [np.ones((n, 1)), cn, pos, (pos * pos).sum(1)[:, None]], 1
    ).astype(np.float32)
    B, jt = pack_adopt_tables(*(jnp.asarray(a) for a in (
        nk, ck, bk, ccdk, reach2, lane_ok.astype(np.float32),
        rows.astype(np.float32))))
    jad, jrow, jacc = jax_plane_adopt(
        jnp.asarray(pay), jnp.asarray(holes), B, jt, th_thickness=TH,
        th_cos=CTH, signed=signed, tile=TILE, interpret=True,
        transposed=False,
    )
    jad, jrow, jacc = np.asarray(jad), np.asarray(jrow), np.asarray(jacc)
    T = torch.from_numpy
    lane_rows = torch.zeros(128, dtype=torch.int32)
    lane_rows[:k] = T(rows)
    ad, row, acc = plane_adopt(
        T(pay), T(holes),
        adopt_table(T(nk), T(ck), T(bk), T(ccdk), T(reach2), T(lane_ok)),
        lane_rows, th_thickness=TH, th_cos=CTH, signed=signed,
    )
    ad, row, acc = ad.numpy(), row.numpy(), acc.numpy()
    assert jad.sum() > 200
    assert (ad != jad).sum() <= 0.001 * n
    both = ad & jad
    np.testing.assert_array_equal(row[both], jrow[both])
    assert np.abs(acc - jacc).max() / np.abs(jacc).max() < 1e-5
