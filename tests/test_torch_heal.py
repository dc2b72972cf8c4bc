"""The multigrid ``heal`` switch of the port against the JAX package's.

``segment_planes_multigrid(..., heal=True | "merge" | False)`` runs in
both packages on the CPU on the Morton-sorted scene of
tests/test_torch_multigrid.py, under its "hinted" settings.  The
contract is that of tests/test_forced_tpu_path.py: the same plane count,
cross agreement ≥ 0.99 and truth agreement within 0.01.  The switch reaches the outermost finalize only (the inner level
heals fully in both packages); the port's finalize takes the segment sums
(``plane_sums``, kernel #8's plain version here) at ``heal=False``, the
payload-moment sums otherwise, and adopts holes only at ``heal=True``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_argsort
from buildingsegment_tpu.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu.seg.coarse import (
    segment_planes_multigrid as jax_multigrid,
)
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.seg import coarse
from buildingsegment_tpu_torch.seg.coarse import segment_planes_multigrid


@pytest.fixture(scope="module")
def problem():
    pts, truth = make_building_cloud(
        seed=1, spacing_mm=150.0, width_mm=10_000.0, depth_mm=8_000.0,
        wall_h_mm=5_000.0, ridge_h_mm=6_500.0, noise_mm=8.0,
    )
    n = len(pts)
    cap = ((n + 2047) // 2048) * 2048
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    order = np.asarray(morton_argsort(jnp.asarray(pos), jnp.asarray(mask)))
    spos, smask = pos[order], mask[order]
    dk, nrm, curv = knn_normals_window_stats(
        jnp.asarray(spos, jnp.float32), jnp.asarray(smask), k=15,
        window=48, radius=300.0, max_nn=50,
    )
    struth = np.full(cap, -1)
    struth[:n] = truth
    return (spos, smask, np.array(dk), np.array(nrm), np.array(curv),
            struth[order])


def _counting(monkeypatch, names):
    """Count the finalize's calls of the named ``coarse`` functions."""
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for name in names:
        monkeypatch.setattr(coarse, name, wrap(name, getattr(coarse, name)))
    return calls


@pytest.mark.parametrize("heal", [True, "merge", False],
                         ids=["full", "merge", "none"])
def test_heal_matches_jax(problem, heal, monkeypatch):
    spos, smask, dk, nrm, curv, struth = problem
    common = dict(max_planes=1024, window=16, group=4, levels=2,
                  refine_sweeps=2, heal=heal, max_edge_dist=900.0,
                  th_point_count=120, spacing_hint_mm=256.0)
    rows = np.arange(spos.shape[0], dtype=np.int32)
    a = jax_multigrid(
        jnp.asarray(spos), jnp.asarray(nrm),
        jnp.asarray(np.stack([rows, rows], 1)), jnp.asarray(smask),
        kth_sq_dist=jnp.asarray(dk), curvature=jnp.asarray(curv), **common,
    )
    calls = _counting(monkeypatch, ("plane_sums", "plane_payload_moment_sums",
                                    "plane_adopt"))
    b = segment_planes_multigrid(
        torch.from_numpy(spos), torch.from_numpy(nrm),
        torch.from_numpy(smask), kth_sq_dist=torch.from_numpy(dk),
        curvature=torch.from_numpy(curv), **common,
    )
    # the inner level always heals: one payload-moment pass and one
    # adoption there; the outermost finalize follows the switch
    assert calls == {
        "plane_sums": int(heal is False),
        "plane_payload_moment_sums": 1 + int(heal is not False),
        "plane_adopt": 1 + int(heal is True),
    }, calls
    la, lb = np.asarray(a.plane_idx)[smask], b.plane_idx.numpy()[smask]
    assert b.num_planes == int(a.num_planes) >= 5
    assert bij_agreement(la, lb) >= 0.99
    ag_a = bij_agreement(struth[smask], la)
    ag_b = bij_agreement(struth[smask], lb)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)
    np.testing.assert_array_equal(b.diagnostics.numpy(),
                                  np.asarray(a.diagnostics))
    p = b.num_planes
    np.testing.assert_array_equal(b.plane_count.numpy()[:p],
                                  np.asarray(a.plane_count)[:p])


def test_heal_rejects_unknown(problem):
    spos, smask, dk, nrm, _curv, _ = problem
    with pytest.raises(ValueError, match="heal='adopt'"):
        segment_planes_multigrid(
            torch.from_numpy(spos), torch.from_numpy(nrm),
            torch.from_numpy(smask), kth_sq_dist=torch.from_numpy(dk),
            group=4, levels=2, heal="adopt")
