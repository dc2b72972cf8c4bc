"""Port window solver (segment_planes, propagation="window") against the
JAX package, with the compact loop off and on, on both sides.

Contract: equal plane and sweep counts, cross label agreement (greedy
bijective, utils/quality.py) ≥ 0.99, plane normals within 1e-4.  On this
scene the labels come out identical; the contract leaves room for the
f32 sums of the models, which the two packages may order differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.seg.region_grow import segment_planes as jax_segment
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.seg.region_grow import segment_planes


@pytest.fixture(scope="module")
def problem():
    pts, truth = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    cap = 16384
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos),
                                 torch.from_numpy(mask), True)
    nb_i, nb_d, nrm, curv = knn_normals_window_sorted(
        spos.float(), smask, 16, window=48, radius=100.0, max_nn=50
    )
    return [x.numpy() for x in (spos, nrm, nb_i[:, :15], smask,
                                nb_d[:, :15], curv)]


@pytest.mark.parametrize("compact", [False, True])
def test_window_solver_matches_jax(problem, compact):
    spos, nrm, nb_i, smask, nb_d, curv = problem
    kw = dict(
        max_edge_dist=600.0, th_point_count=50, max_planes=1024,
        max_sweeps=64, convergence_tol=5e-5, compact=compact,
    )
    a = jax_segment(
        jnp.asarray(spos), jnp.asarray(nrm), jnp.asarray(nb_i),
        jnp.asarray(smask), neigh_sq_dist=jnp.asarray(nb_d),
        curvature=jnp.asarray(curv), propagation="window", window=16, **kw,
    )
    t = lambda x: torch.from_numpy(np.array(x))
    b = segment_planes(
        t(spos), t(nrm), t(nb_i), t(smask), neigh_sq_dist=t(nb_d),
        curvature=t(curv), **kw,
    )
    assert b.num_planes == int(a.num_planes) >= 5
    assert b.num_sweeps == int(a.num_sweeps)
    # the compact loop ran after the warm sweeps: one host read per sweep
    # plus the relabel and the final count
    assert b.host_syncs == b.num_sweeps + (2 if compact else 1)
    pa, pb = np.asarray(a.plane_idx), b.plane_idx.numpy()
    assert bij_agreement(pa[smask], pb[smask]) >= 0.99
    np.testing.assert_allclose(b.plane_normal.numpy(),
                               np.asarray(a.plane_normal), atol=1e-4)
    np.testing.assert_array_equal(b.diagnostics.numpy(),
                                  np.asarray(a.diagnostics))
