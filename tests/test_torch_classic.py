"""The port's exact-kNN paths end to end against the JAX package (CPU).

``segment_planes(propagation="graph")`` on the same graph and normals in
both packages, and ``segment_cloud`` with ``knn_method`` "brute" (what
"auto" resolves to at 65,536 points or fewer) and "pallas" (JAX's Pallas
kernel in interpret mode; the port's plain version of kernel #14) on the
8,980-point scene: the forced-path contract of
tests/test_forced_tpu_path.py — the same plane count, cross agreement
≥ 0.99, truth agreement within 0.01 — plus equal sweep counts,
diagnostics and plane member counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buildingsegment_tpu.pipeline as jax_pipeline
from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.ops.knn import knn as jax_knn
from buildingsegment_tpu.ops.normals import estimate_normals as jax_normals
from buildingsegment_tpu.ops.pallas_knn import knn_pallas as jax_knn_pallas
from buildingsegment_tpu.seg.region_grow import segment_planes as jax_segment
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import resolve_knn_method, segment_cloud
from buildingsegment_tpu_torch.seg.region_grow import segment_planes


@pytest.fixture(scope="module")
def scene():
    return make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )


@pytest.fixture(scope="module")
def graph_inputs(scene):
    """The padded scene, its exact 50-NN graph and normals (JAX's)."""
    pts, _ = scene
    cap = 9216
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    idx, d = jax_knn(jnp.asarray(pos), jnp.asarray(mask), k=50)
    nrm, curv = jax_normals(jnp.asarray(pos), jnp.asarray(mask), idx, d,
                            radius=100.0, max_nn=50)
    return pos, mask, idx, nrm, curv


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_graph_solver_matches_jax(graph_inputs, signed):
    pos, mask, idx, nrm, curv = graph_inputs
    kw = dict(th_point_count=400, max_planes=4096, max_sweeps=64,
              convergence_tol=5e-5, signed_normals=signed)
    a = jax_segment(jnp.asarray(pos), nrm, idx[:, :15], jnp.asarray(mask),
                    curvature=curv, propagation="graph", **kw)
    t = lambda x: torch.from_numpy(np.array(x))
    b = segment_planes(t(pos), t(nrm), t(idx[:, :15]), t(mask),
                       curvature=t(curv), propagation="graph", **kw)
    assert b.num_planes == int(a.num_planes) >= 4
    assert b.num_sweeps == int(a.num_sweeps)
    # one read a sweep, the seed count and the final plane count
    assert b.host_syncs == b.num_sweeps + 2
    pa, pb = np.asarray(a.plane_idx), b.plane_idx.numpy()
    assert bij_agreement(pa[mask], pb[mask]) >= 0.99
    np.testing.assert_array_equal(b.plane_count.numpy(),
                                  np.asarray(a.plane_count))
    np.testing.assert_allclose(b.plane_normal.numpy(),
                               np.asarray(a.plane_normal), atol=1e-4)
    np.testing.assert_array_equal(b.diagnostics.numpy(),
                                  np.asarray(a.diagnostics))


@pytest.mark.parametrize("method", ["brute", "pallas"])
def test_segment_cloud_matches_jax(scene, method, monkeypatch):
    pts, truth = scene
    # the small scene is what "auto" sends down the brute path
    assert resolve_knn_method(DEFAULT_CONFIG, 9216) == "brute"
    if method == "pallas":
        monkeypatch.setattr(jax_pipeline, "knn_pallas", functools.partial(
            jax_knn_pallas, interpret=True))
        jax.clear_caches()
    a = jax_pipeline.segment_cloud(JaxHostPointCloud(positions=pts),
                                   JaxPipelineConfig(knn_method=method))
    b = segment_cloud(HostPointCloud(positions=pts),
                      PipelineConfig(knn_method=method), device="cpu")
    assert b.num_planes == a.num_planes >= 4
    assert bij_agreement(a.plane_idx, b.plane_idx) >= 0.99
    ag_a = bij_agreement(truth, a.plane_idx)
    ag_b = bij_agreement(truth, b.plane_idx)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)
    assert b.num_sweeps > 0 and "knn" in b.timings
    np.testing.assert_array_equal(b.plane_counts, a.plane_counts)
    np.testing.assert_allclose(b.plane_normals, a.plane_normals, atol=1e-4)
    # the exact-kNN paths read no spacing hint, so none is measured;
    # "pallas" reports the candidate tiles its 72 query tiles of 128 rows
    # listed, each of 9 tiles of 1,024
    tiles = {k: b.diagnostics.pop(k) for k in ("knn_tiles_listed",
                                                "knn_query_tiles")
             if k in b.diagnostics}
    assert b.diagnostics == dict(
        a.diagnostics, occupied_cells_512mm=0, spacing_hint_mm=0.0)
    if method == "pallas":
        assert tiles["knn_query_tiles"] == 72
        assert 72 <= tiles["knn_tiles_listed"] <= 72 * 9
    else:
        assert tiles == {}
