"""The port's block-form stats sweep (#15) against the JAX package's.

``ops.stats_mxu.stats_mxu_reference`` (the plain version of the port's
kernel) is held against ``fused_stats_mxu`` (``_stats_mxu_kernel``) run
in interpret mode on the CPU, in the two regimes of the JAX package's
own test (tests/test_stats_mxu.py):

  * small span (coordinates < 256): every intermediate is an exact f32
    integer, so the outputs are bit-identical;
  * building span: the matmul form rounds; dk within max(8, 3e-4·dk),
    s0 different on fewer than 2% of the rows, where s0 agrees the
    99.9th-percentile normal angle below 0.1° and curvature within 1e-3.

The routing of ``stats_rank_mode``: "mxu" takes the block form, None,
"bitonic" and "bisect" the exact sweep's bits, anything else raises.
Inputs are made with numpy from a seed: 2,048 rows, tile 1,024.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.ops.fused import finish_normals as jax_finish
from buildingsegment_tpu.ops.stats_mxu import fused_stats_mxu
from buildingsegment_tpu.ops.window_sweep import make_slab
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.stats_mxu import stats_mxu_reference
from buildingsegment_tpu_torch.ops.stats_sweep import (
    knn_normals_window_stats,
    stats_sweep_reference,
)

CAP, TILE = 2048, 1024
# the house at 280 mm spacing: 1,572 points in 2,048 rows, coordinates
# up to ~8 m; the radius spans about two spacings, as the default 100 mm
# does on the 55 mm scans (a radius below the spacing leaves one or two
# neighbours, whose normals no rounding pins down)
BUILDING = dict(seed=5, spacing_mm=280.0, width_mm=5000.0, depth_mm=4000.0,
                wall_h_mm=3000.0, ridge_h_mm=4000.0)
BUILDING_RADIUS = 600.0


def _sorted(pos, mask):
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    return np.array(spos, np.float32), np.array(smask)


def _padded(pts):
    pos = np.full((CAP, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(CAP, bool)
    mask[: len(pts)] = True
    return _sorted(pos, mask)


def _both(spos, smask, **kw):
    slab = make_slab(
        [jnp.asarray(spos[:, d]) for d in range(3)]
        + [jnp.asarray(smask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0], kw["w"], TILE, rows_out=8,
    )
    want = fused_stats_mxu(slab, spos.shape[0], tile=TILE, interpret=True,
                           **kw)
    pos = tuple(torch.from_numpy(np.ascontiguousarray(spos[:, d]))
                for d in range(3))
    got = stats_mxu_reference(pos, torch.from_numpy(smask), **kw)
    return [np.asarray(a) for a in want], [g.numpy() for g in got]


@pytest.mark.parametrize(
    "k,w,radius,max_nn",
    [
        (15, 64, 100.0, 50),   # reference defaults
        (15, 64, 40.0, 50),    # tight radius
        (16, 32, 1e6, 16),     # entry()/test config
        (15, 32, 60.0, None),  # no hybrid cap
        (15, 48, 80.0, 20),    # the port's window, C = 224
    ],
)
def test_stats_mxu_small_span_bit_exact(k, w, radius, max_nn):
    rng = np.random.default_rng(0)
    spos, smask = _padded(rng.integers(0, 250, (1500, 3)).astype(np.int32))
    want, got = _both(spos, smask, k=k, w=w, radius=radius, max_nn=max_nn)
    for g, r, name in zip(got, want, ("dk", "s0", "s1", "s2")):
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_stats_mxu_sparse_masks_bit_exact():
    """Mostly masked rows, whole blocks without a valid candidate (origin
    0) and degenerate balls stay bit-identical."""
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 200, (400, 3)).astype(np.int32)
    pos = np.full((CAP, 3), 2**24, np.int32)
    mask = np.zeros(CAP, bool)
    sel = rng.choice(CAP, len(pts), replace=False)
    pos[sel] = pts
    mask[sel] = True
    spos, smask = _sorted(pos, mask)
    want, got = _both(spos, smask, k=15, w=64, radius=100.0, max_nn=50)
    assert not smask[1024:].any()  # the last 8 blocks hold no valid row
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)


def test_stats_mxu_building_span_tolerance():
    pts, _ = make_building_cloud(**BUILDING)
    spos, m = _padded(pts)
    want, got = _both(spos, m, k=15, w=64, radius=BUILDING_RADIUS,
                      max_nn=50)
    dk_r, dk_g = want[0][m], got[0][m]
    dk_err = np.abs(dk_r - dk_g)
    assert np.all(dk_err <= np.maximum(8.0, 3e-4 * dk_r)), (
        f"dk: max abs err {dk_err.max()}, max rel "
        f"{(dk_err / np.maximum(dk_r, 1.0)).max()}")
    s0_r, s0_g = want[1][m], got[1][m]
    frac = np.mean(s0_r != s0_g)
    assert frac < 0.02, f"s0 differs on {frac:.4%} of the rows"
    nrm_r, curv_r = (np.asarray(a) for a in jax_finish(
        jnp.asarray(s0_r), jnp.asarray(want[2][m]), jnp.asarray(want[3][m])))
    nrm_g, curv_g = (np.asarray(a) for a in jax_finish(
        jnp.asarray(s0_g), jnp.asarray(got[2][m]), jnp.asarray(got[3][m])))
    same = s0_r == s0_g
    ang = np.degrees(np.arccos(np.clip(
        np.abs(np.sum(nrm_r * nrm_g, -1)), 0, 1)))[same]
    p999 = np.percentile(ang, 99.9)
    assert p999 < 0.1, f"99.9th-percentile normal angle {p999}°"
    curv_err = np.abs(curv_r - curv_g)[same].max()
    assert curv_err < 1e-3, f"curvature max abs err {curv_err}"


@pytest.fixture(scope="module")
def house():
    pts, _ = make_building_cloud(**BUILDING)
    spos, smask = _padded(pts)
    return torch.from_numpy(spos), torch.from_numpy(smask)


@pytest.mark.parametrize("mode", [None, "bitonic", "bisect", "mxu"])
def test_rank_mode_routes(house, mode):
    """None, "bitonic" and "bisect" give the exact sweep's bits, "mxu"
    the block form's."""
    spos, smask = house
    kw = dict(k=15, w=48, radius=BUILDING_RADIUS, max_nn=50)
    pos = tuple(spos[:, d].contiguous() for d in range(3))
    want = (stats_mxu_reference if mode == "mxu"
            else stats_sweep_reference)(pos, smask, **kw)
    dk, _nrm, _curv = knn_normals_window_stats(
        spos, smask, 15, window=48, radius=BUILDING_RADIUS, max_nn=50,
        rank_mode=mode)
    assert torch.equal(dk, want[0])
    if mode == "mxu":  # the two roundings differ at building span
        assert not torch.equal(dk, stats_sweep_reference(pos, smask, **kw)[0])


def test_rank_mode_unknown_raises(house):
    spos, smask = house
    with pytest.raises(ValueError, match="rank_mode"):
        knn_normals_window_stats(spos, smask, 15, window=48, rank_mode="mxv")
