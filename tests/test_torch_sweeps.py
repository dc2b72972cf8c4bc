"""The port's window sweeps against the JAX package's Pallas kernels.

``label_sweep`` and ``compact_sweep`` of buildingsegment_tpu_torch run
their plain PyTorch versions here (CPU tensors); the JAX kernels run in
Pallas interpret mode on the same numpy inputs.  Both sweeps are min/or
chains over identical f32 operations, and the compact sweep's per-slot
sums run in the same block order as the TPU kernel's column blocks, so
labels, hooks and change counts must be EXACTLY equal.  The CUDA kernels
are compared with these plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.compact_sweep import compact_sweep as jax_compact
from buildingsegment_tpu.ops.window_sweep import (
    label_sweep as jax_label_sweep,
    make_dyn_row,
    make_slab,
    pick_tile,
)
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.compact_sweep import (
    COMPACT_L,
    compact_sweep,
)
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.window_sweep import label_sweep

TH, CTH, EDGE = 300.0, 0.88, 600.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(spacing_mm, cap):
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=spacing_mm, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    assert len(pts) <= cap
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    # the port's own stage 1 makes the inputs (fast on the CPU); both
    # packages then get the same arrays
    spos, smask, _ = morton_sort(_t(pos), _t(mask), True)
    sposf = spos.float()
    _, _, nrm, _ = knn_normals_window_sorted(
        sposf, smask, 16, window=32, radius=300.0, max_nn=50
    )
    return sposf.numpy(), nrm.numpy(), smask.numpy()




@pytest.fixture(scope="module")
def scene():
    pos, nrm, mask = _scene(240.0, 4096)
    return pos, nrm, canonicalize_normals(_t(nrm)).numpy(), mask


@pytest.fixture(scope="module")
def label_scene(scene):
    pos, nrm, _, mask = scene
    n = len(mask)
    rng = np.random.default_rng(3)
    # labels: groups of consecutive rows share their first row's id, a
    # fifth of the rows unlabeled; models = the label row's normal and a
    # jittered copy of its position, so hops and merges both fire
    rows = np.arange(n)
    label = (rows // 7 * 7).astype(np.int32)
    label[rng.random(n) < 0.2] = n
    label[~mask] = n
    src = np.minimum(label, n - 1)
    has = label < n
    mn = np.where(has[:, None], nrm[src], 0.0).astype(np.float32)
    mc = np.where(
        has[:, None], pos[src] + rng.normal(0, 40.0, (n, 3)), 0.0
    ).astype(np.float32)
    return pos, nrm, mn, mc, label, mask


# w=16 is the solver's window; the signed variant runs at w=8 to halve
# the interpret-mode compile
@pytest.mark.parametrize("signed,w", [(False, 16), (True, 8)])
def test_label_sweep_matches_pallas_kernel(label_scene, signed, w):
    pos, nrm, mn, mc, label, mask = label_scene
    n = len(label)
    eg2 = EDGE ** 2
    cols = [pos[:, 0], pos[:, 1], pos[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            mn[:, 0], mn[:, 1], mn[:, 2], mc[:, 0], mc[:, 1], mc[:, 2]]
    tile = pick_tile(n, 1024)  # several row tiles
    assert tile < n
    slab = make_slab(
        [jnp.asarray(c) for c in cols]
        + [jnp.asarray(label.astype(np.float32)),
           jnp.asarray(mask.astype(np.float32))],
        [-3e7, -3e7, -3e7] + [0.0] * 9 + [float(n), 0.0], w, tile,
    )
    j_new, j_best = jax_label_sweep(
        slab, n, w=w, tile=tile, th_thickness=TH, th_normal_cos=CTH,
        edge_gate2=eg2, inf_label=float(n), signed=signed, interpret=True,
    )
    tc = [_t(c) for c in cols]
    t_new, t_best = label_sweep(
        tc[0:3], tc[3:6], tc[6:9], tc[9:12], _t(label), _t(mask), w=w,
        th_thickness=TH, th_normal_cos=CTH, edge_gate2=eg2, inf_label=n,
        signed=signed,
    )
    j_new = np.asarray(j_new).astype(np.int32)
    j_best = np.asarray(j_best).astype(np.int32)
    assert (j_new != label).sum() > 100 and (j_best < n).sum() > 100
    np.testing.assert_array_equal(t_new.numpy(), j_new)
    np.testing.assert_array_equal(t_best.numpy(), j_best)


@pytest.mark.parametrize("anchor_gate", [True, False])
def test_compact_sweep_matches_pallas_kernel(scene, anchor_gate):
    """Three chained sweeps from the seed-singleton state (every row its
    own slot): labels and change counts exact at each step, both fed
    the JAX kernel's previous output."""
    pos, nrm, cnrm, mask = scene
    n, w, lc = len(mask), 8, COMPACT_L
    eg2 = EDGE ** 2
    thac = 0.95 if anchor_gate else 0.0
    rng = np.random.default_rng(4)
    live = mask & (rng.random(n) < 0.45)
    clab = np.where(live, np.cumsum(live) - 1, lc).astype(np.int32)
    bound = int(live.sum())
    assert bound <= lc
    anchor = np.zeros((lc, 3), np.float32)
    anchor[clab[live]] = cnrm[live]
    ctile = -(-n // 128) * 128
    spine = make_slab(
        [jnp.asarray(c) for c in (
            pos[:, 0], pos[:, 1], pos[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            cnrm[:, 0], cnrm[:, 1], cnrm[:, 2], mask.astype(np.float32))],
        [-3e7, -3e7, -3e7] + [0.0] * 7, w, ctile, rows_out=16,
    )
    anchor8 = jnp.asarray(
        np.concatenate([anchor.T, np.zeros((5, lc), np.float32)], 0)
    )
    tpos = [_t(pos[:, d]) for d in range(3)]
    tnrm = [_t(nrm[:, d]) for d in range(3)]
    tcn = [_t(cnrm[:, d]) for d in range(3)]
    for _ in range(3):
        dyn = make_dyn_row(jnp.asarray(clab.astype(np.float32)), float(lc),
                           w, ctile)
        j_lab, j_cnt = jax_compact(
            spine, dyn, anchor8, bound, n, w=w, tile=ctile, lc=lc,
            th_thickness=TH, th_normal_cos=CTH, edge_gate2=eg2,
            th_anchor_cos=thac, anchor_gate=anchor_gate, interpret=True,
        )
        j_lab = np.asarray(j_lab).astype(np.int32)
        t_lab, counters = compact_sweep(
            tpos, tnrm, tcn, _t(mask), _t(clab), _t(anchor), bound, lc=lc,
            w=w, th_thickness=TH, th_normal_cos=CTH, edge_gate2=eg2,
            root_gate=EDGE, th_anchor_cos=thac, anchor_gate=anchor_gate,
        )
        np.testing.assert_array_equal(t_lab.numpy(), j_lab)
        assert int(counters[0]) == int(j_cnt) > 0
        top = int(np.where(j_lab < lc, j_lab, 0).max())
        assert int(counters[1]) == top
        clab, bound = j_lab, min(top + 1, bound)


def test_compact_sweep_matches_pallas_kernel_wide_bound(scene):
    """A live bound of 700 slots (one row each): the JAX kernel's pair
    tests take two 512-column blocks and the CUDA kernel's 128-row tiles
    end inside the table; two chained sweeps, labels and change counts
    exact."""
    pos, nrm, cnrm, mask = scene
    n, w, lc, bound = len(mask), 8, COMPACT_L, 700
    eg2 = EDGE ** 2
    rng = np.random.default_rng(6)
    live = np.zeros(n, bool)
    live[rng.permutation(np.flatnonzero(mask))[:bound]] = True
    assert live.sum() == bound
    clab = np.where(live, np.cumsum(live) - 1, lc).astype(np.int32)
    anchor = np.zeros((lc, 3), np.float32)
    anchor[clab[live]] = cnrm[live]
    ctile = -(-n // 128) * 128
    spine = make_slab(
        [jnp.asarray(c) for c in (
            pos[:, 0], pos[:, 1], pos[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            cnrm[:, 0], cnrm[:, 1], cnrm[:, 2], mask.astype(np.float32))],
        [-3e7, -3e7, -3e7] + [0.0] * 7, w, ctile, rows_out=16,
    )
    anchor8 = jnp.asarray(
        np.concatenate([anchor.T, np.zeros((5, lc), np.float32)], 0)
    )
    tpos = [_t(pos[:, d]) for d in range(3)]
    tnrm = [_t(nrm[:, d]) for d in range(3)]
    tcn = [_t(cnrm[:, d]) for d in range(3)]
    for _ in range(2):
        dyn = make_dyn_row(jnp.asarray(clab.astype(np.float32)), float(lc),
                           w, ctile)
        j_lab, j_cnt = jax_compact(
            spine, dyn, anchor8, bound, n, w=w, tile=ctile, lc=lc,
            th_thickness=TH, th_normal_cos=CTH, edge_gate2=eg2,
            th_anchor_cos=0.95, anchor_gate=True, interpret=True,
        )
        j_lab = np.asarray(j_lab).astype(np.int32)
        t_lab, counters = compact_sweep(
            tpos, tnrm, tcn, _t(mask), _t(clab), _t(anchor), bound, lc=lc,
            w=w, th_thickness=TH, th_normal_cos=CTH, edge_gate2=eg2,
            root_gate=EDGE, th_anchor_cos=0.95, anchor_gate=True,
        )
        np.testing.assert_array_equal(t_lab.numpy(), j_lab)
        assert int(counters[0]) == int(j_cnt) > 0
        top = int(np.where(j_lab < lc, j_lab, 0).max())
        assert int(counters[1]) == top
        clab, bound = j_lab, min(top + 1, bound)
