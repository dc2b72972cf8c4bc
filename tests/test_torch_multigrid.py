"""The port's multigrid solver against the JAX package's, on the CPU.

``segment_planes_multigrid`` runs in both packages on the same
Morton-sorted scene, normals and seed balls.  The port follows the JAX
package's kernel branch (with the kernels' plain versions); JAX on the
CPU follows its XLA branch, which sums in another order.  The contract
is that of tests/test_forced_tpu_path.py: the same plane count, cross
agreement ≥ 0.99 and truth agreement within 0.01.

Each JAX run compiles a program of its own, so the settings are spread
over three files, each of which builds the scene once: here the
"hinted" and "coarse_seeds" settings and the full ``heal`` switch of
tests/test_torch_heal.py (the hinted settings at ``heal=True``, JAX's
default, so one JAX run serves both);
tests/test_torch_multigrid_defaults.py the default settings;
tests/test_torch_heal.py the other two ``heal`` switches.
"""

import inspect

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

SETTINGS = {
    "hinted": dict(max_edge_dist=900.0, th_point_count=120,
                   spacing_hint_mm=256.0),
    "defaults": dict(max_edge_dist=600.0, th_point_count=400),
    # group seeds from the coherence statistics: no seed sweep
    "coarse_seeds": dict(max_edge_dist=600.0, th_point_count=400,
                         seed_source="coarse", th_seed_curvature=0.02),
}
HEAL = {"full": True, "merge": "merge", "none": False}
COMMON = dict(max_planes=1024, window=16, group=4, levels=2,
              refine_sweeps=2)


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


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX's ``segment_planes_multigrid`` on the scene, once per set of
    arguments for the file (``heal`` at its default when not given)."""
    spos, smask, dk, nrm, curv, _ = problem
    rows = np.arange(spos.shape[0], dtype=np.int32)
    heal_default = inspect.signature(jax_multigrid).parameters["heal"].default
    done = {}

    def run(**kw):
        key = tuple(sorted(dict({"heal": heal_default}, **kw).items()))
        if key not in done:
            done[key] = jax_multigrid(
                jnp.asarray(spos), jnp.asarray(nrm),
                jnp.asarray(np.stack([rows, rows], 1)), jnp.asarray(smask),
                kth_sq_dist=jnp.asarray(dk), curvature=jnp.asarray(curv),
                **kw,
            )
        return done[key]
    return run


def port_run(problem, **kw):
    spos, smask, dk, nrm, curv, _ = problem
    return segment_planes_multigrid(
        torch.from_numpy(spos), torch.from_numpy(nrm),
        torch.from_numpy(smask), kth_sq_dist=torch.from_numpy(dk),
        curvature=torch.from_numpy(curv), **kw,
    )


def hold_contract(problem, a, b):
    """The forced-path contract and the diagnostics."""
    _, smask, _, _, _, struth = problem
    la, lb = np.asarray(a.plane_idx)[smask], b.plane_idx.numpy()[smask]
    assert b.num_planes == int(a.num_planes) >= 5
    assert bij_agreement(la, lb) >= 0.99
    ag_a = bij_agreement(struth[smask], la)
    ag_b = bij_agreement(struth[smask], lb)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)
    np.testing.assert_array_equal(b.diagnostics.numpy(),
                                  np.asarray(a.diagnostics))


def check_multigrid(problem, jax_runs, name):
    common = dict(COMMON, **SETTINGS[name])
    a = jax_runs(**common)
    b = port_run(problem, **common)
    hold_contract(problem, a, b)
    assert b.num_sweeps == int(a.num_sweeps)
    p = b.num_planes
    np.testing.assert_array_equal(b.plane_count.numpy()[p:], 0)
    np.testing.assert_allclose(
        np.abs(np.sum(b.plane_normal.numpy()[:p]
                      * np.asarray(a.plane_normal)[:p], 1)), 1.0, atol=1e-3)


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


def check_heal(problem, jax_runs, monkeypatch, name):
    """tests/test_torch_heal.py's case: the hinted settings at one
    ``heal`` switch."""
    heal = HEAL[name]
    common = dict(COMMON, **SETTINGS["hinted"], heal=heal)
    a = jax_runs(**common)
    calls = _counting(monkeypatch, ("plane_sums", "plane_payload_moment_sums",
                                    "plane_adopt"))
    b = port_run(problem, **common)
    # the inner level always heals: one payload-moment pass and one
    # adoption there; the outermost finalize follows the switch
    assert calls == {
        "plane_sums": int(heal is False),
        "plane_payload_moment_sums": 1 + int(heal is not False),
        "plane_adopt": 1 + int(heal is True),
    }, calls
    hold_contract(problem, a, b)
    p = b.num_planes
    np.testing.assert_array_equal(b.plane_count.numpy()[:p],
                                  np.asarray(a.plane_count)[:p])


@pytest.mark.parametrize("name", ["hinted", "coarse_seeds"])
def test_multigrid_matches_jax(problem, jax_runs, name):
    check_multigrid(problem, jax_runs, name)


@pytest.mark.parametrize("name", ["full"])
def test_heal_matches_jax(problem, jax_runs, monkeypatch, name):
    check_heal(problem, jax_runs, monkeypatch, name)
