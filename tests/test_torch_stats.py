"""The port's stats sweep against the JAX package's.

The plain version of the stats kernel (``ops/stats_sweep.py``) is held
against the Pallas ``_stats_kernel`` run in interpret mode, at the JAX
package's own tolerance (tests/test_stats_sweep.py): the k-th-NN squared
distance is an order statistic and must be bit-exact; normals within a
99th-percentile angle of 0.2°, curvature within 1e-4.  The port's
``knn_normals_window_stats`` is held against the JAX one (its XLA path
on the CPU) the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.ops.fused import finish_normals as jax_finish
from buildingsegment_tpu.ops.stats_sweep import (
    fused_stats_sweep,
    knn_normals_window_stats as jax_stats,
)
from buildingsegment_tpu.ops.window_sweep import make_slab
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.fused import finish_normals
from buildingsegment_tpu_torch.ops.stats_sweep import (
    knn_normals_window_stats,
    stats_sweep,
    stats_sweep_reference,
)


def _sorted(pts, cap):
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    return np.array(spos, np.float32), np.array(smask)


@pytest.fixture(scope="module")
def sorted_cloud():
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    return _sorted(pts, 16384)


def _cols(spos):
    t = torch.from_numpy(spos)
    return tuple(t[:, d].contiguous() for d in range(3))


def _angles_deg(a, b):
    cos = np.clip(np.abs(np.sum(np.asarray(a) * np.asarray(b), -1)), 0, 1)
    return np.degrees(np.arccos(cos))


@pytest.mark.parametrize(
    "k,w,radius,max_nn",
    [(15, 48, 100.0, 50), (15, 32, 300.0, None), (15, 48, 600.0, 50)],
    ids=["production", "no_cap", "cap_binds"],
)
def test_stats_plain_matches_pallas_kernel(sorted_cloud, k, w, radius,
                                           max_nn):
    spos, smask = sorted_cloud
    slab = make_slab(
        [jnp.asarray(spos[:, d]) for d in range(3)]
        + [jnp.asarray(smask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0], w, 256, rows_out=8,
    )
    jdk, js0, js1, js2 = fused_stats_sweep(
        slab, spos.shape[0], k=k, w=w, tile=256, radius=radius,
        max_nn=max_nn, interpret=True,
    )
    jdk = np.where(smask, np.asarray(jdk), 0.0)
    dk, s0, s1, s2 = stats_sweep_reference(
        _cols(spos), torch.from_numpy(smask), k=k, w=w, radius=radius,
        max_nn=max_nn,
    )
    # an order statistic: bit for bit, including the empty balls
    np.testing.assert_array_equal(dk.numpy(), jdk)
    assert (jdk > 0).sum() > 1000
    np.testing.assert_array_equal(s0.numpy(), np.asarray(js0))
    if radius > 300.0:
        # the hybrid cap decides these balls: the plain version's cap rank
        # (self row included) is the kernel's rank-(max_nn − 1)
        assert int((s0 == max_nn).sum()) > 1000
    jn, jc = jax_finish(js0, js1, js2)
    n, c = finish_normals(s0, s1, s2)
    assert np.percentile(_angles_deg(n.numpy(), jn)[smask], 99) < 0.2
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)


@pytest.mark.parametrize(
    "k,w,radius,max_nn",
    [(15, 48, 100.0, 50), (15, 32, 300.0, None), (15, 48, 600.0, 50)],
    ids=["production", "no_cap", "cap_binds"],
)
def test_cap_skip_is_exact(sorted_cloud, k, w, radius, max_nn):
    """What csrc/stats_sweep.cu relies on to skip the cap's selection: on
    every row with fewer than max_nn − 1 candidates within the radius,
    the moments equal those over d ≤ r² alone, bit for bit."""
    spos, smask = sorted_cloud
    mask = torch.from_numpy(smask)
    kw = dict(k=k, w=w, radius=radius)
    dk, s0, s1, s2 = stats_sweep_reference(_cols(spos), mask,
                                           max_nn=max_nn, **kw)
    _, r0, r1, r2 = stats_sweep_reference(_cols(spos), mask, max_nn=None,
                                          **kw)
    within = r0 - mask.float()  # candidates within the radius
    r_cap = (max_nn - 1) if max_nn is not None and max_nn - 1 < 2 * w else 0
    free = within < r_cap if r_cap else torch.ones_like(mask)
    for a, b in ((s0, r0), (s1, r1), (s2, r2)):
        assert torch.equal(a[free], b[free])
    assert int(free.sum()) > 1000
    if radius > 300.0:  # the cap binds elsewhere, and changes the moments
        assert int((~free).sum()) > 1000
        assert not torch.equal(s0[~free], r0[~free])


def test_knn_normals_window_stats_matches_jax(sorted_cloud):
    spos, smask = sorted_cloud
    jdk, jn, jc = jax_stats(jnp.asarray(spos), jnp.asarray(smask), k=15,
                            window=48, radius=100.0, max_nn=50)
    dk, n, c = knn_normals_window_stats(
        torch.from_numpy(spos), torch.from_numpy(smask), 15, window=48,
        radius=100.0, max_nn=50,
    )
    np.testing.assert_array_equal(dk.numpy(), np.asarray(jdk))
    assert np.percentile(_angles_deg(n.numpy(), jn)[smask], 99) < 0.2
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)


def test_sparse_cloud_degenerate_balls():
    """Fewer than k−1 valid candidates → dk = 0.0, and masked rows get a
    zero ball and zero moments."""
    pts = np.array([[0, 0, 0], [100000, 0, 0], [0, 100000, 0]], np.int32)
    spos, smask = _sorted(pts, 2048)
    dk, s0, s1, s2 = stats_sweep(
        _cols(spos), torch.from_numpy(smask), k=15, w=32, radius=100.0,
        max_nn=50,
    )
    assert float(dk.abs().max()) == 0.0
    np.testing.assert_array_equal(s0.numpy(), smask.astype(np.float32))
    assert float(s1.abs().max()) == 0.0 and float(s2.abs().max()) == 0.0
