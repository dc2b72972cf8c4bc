"""The port's exact-kNN stage against the JAX package (CPU).

* ``morton_argsort`` (plain and on the translated ``_DUAL_SHIFT`` order)
  and ``knn_window_sorted`` at w = 50, k = 50: EXACT (integer keys; the
  same f32 distances, ties by slot as ``lax.top_k``).
* The brute ``knn`` against JAX's ``knn`` at k = 16 and k = 50
  (``_check``, which tests/test_torch_knn_pallas.py also holds
  ``knn_pallas`` to): distances within JAX's oracle tolerance, rtol 1e-6
  and atol 0.01 mm² (tests/test_pallas_knn.py) — the two packages center
  on different means, and JAX's f32 center makes its own coordinates
  inexact; indices equal except where two candidates at the cut lie
  within that tolerance; every returned index's recomputed d² equals the
  returned d² exactly; and against scipy's ``cKDTree`` as well.
* ``estimate_normals`` on the same graph (JAX's k = 50 lists, computed
  once for the file): normals up to sign within 1e-5 on rows whose two
  smallest eigenvalues are separated (gap ≥ 5% of the largest),
  curvature within 1e-5 (tests/test_torch_fused.py's rule).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from buildingsegment_tpu.core.morton import morton_argsort as jax_argsort
from buildingsegment_tpu.ops.knn import (
    _DUAL_SHIFT,
    knn as jax_knn,
    knn_window_sorted as jax_window,
)
from buildingsegment_tpu.ops.normals import estimate_normals as jax_normals
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.core.morton import morton_argsort
from buildingsegment_tpu_torch.ops.knn import (
    DUAL_SHIFT,
    knn,
    knn_window_sorted,
    masked_center,
)
from buildingsegment_tpu_torch.ops.normals import estimate_normals

TOL = dict(rtol=1e-6, atol=0.01)
T = lambda a: torch.from_numpy(np.array(a))


def _padded(pts, cap):
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    return pos, mask


@pytest.fixture(scope="module")
def scene():
    """The 8,980-point test scene at capacity 9,216, Morton-sorted."""
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    pos, mask = _padded(pts, 9216)
    order = np.asarray(jax_argsort(jnp.asarray(pos), jnp.asarray(mask)))
    return pos[order], mask[order]


@pytest.fixture(scope="module")
def jax_graph(scene):
    """JAX's brute ``knn`` of the scene at k → (idx, d2) as numpy, each k
    computed once for the file."""
    pos, mask = scene

    @functools.lru_cache(maxsize=None)
    def graph(k):
        return tuple(np.asarray(a) for a in jax_knn(jnp.asarray(pos),
                                                    jnp.asarray(mask), k=k))
    return graph


def _random(seed, n, cap, extent):
    pts = np.random.default_rng(seed).integers(0, extent, (n, 3))
    return _padded(pts.astype(np.int32), cap)


def _near_tie_only(ti, td, ji, jd, mask):
    """Per valid row: the same distances slot by slot, and index sets
    that differ only in candidates within tolerance of the cut."""
    np.testing.assert_allclose(td[mask], jd[mask], **TOL)
    cut = np.maximum(td[:, -1], jd[:, -1])
    for r in np.nonzero(mask & (ti != ji).any(1))[0]:
        diff = set(ti[r]) ^ set(ji[r])
        dist = dict(zip(ti[r], td[r])) | dict(zip(ji[r], jd[r]))
        for c in diff:
            assert dist[c] >= cut[r] - (TOL["atol"] + TOL["rtol"] * cut[r]), r


def _check(ti, td, ji, jd, pos, mask):
    """The port's (ti, td) against JAX's (ji, jd) and against cKDTree."""
    n = int(mask.sum())
    assert (ti[:, 0] == np.arange(len(ti))).all()
    _near_tie_only(ti, td, ji, jd, mask)
    # each returned index's d², recomputed on the port's centered frame
    c = (T(pos).float() - masked_center(T(pos), T(mask))).numpy()
    diff = c[ti] - c[:, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
         + diff[..., 2] * diff[..., 2])
    np.testing.assert_array_equal(np.where(ti == np.arange(len(ti))[:, None],
                                           0.0, d)[mask], td[mask])
    # oracle: the first n rows are the valid ones
    k = ti.shape[1]
    od, _ = cKDTree(pos[:n].astype(np.float64)).query(pos[:n], k=k)
    np.testing.assert_allclose(td[:n], od**2, **TOL)
    assert not (ti[~mask] != np.arange(len(ti))[~mask, None]).any()


@pytest.mark.parametrize("dual", [False, True], ids=["plain", "dual_shift"])
def test_morton_argsort_exact(scene, dual):
    assert DUAL_SHIFT == _DUAL_SHIFT
    pos, mask = _random(3, 3000, 4096, 1 << 21)  # past the 20-bit clip
    pos[:100] = pos[100:200]  # equal codes: ties go by index
    for p, m in ((pos, mask), scene):
        if dual:
            p = p + np.asarray(_DUAL_SHIFT, np.int32)
        j = np.asarray(jax_argsort(jnp.asarray(p), jnp.asarray(m)))
        np.testing.assert_array_equal(morton_argsort(T(p), T(m)).numpy(), j)


def test_knn_window_sorted_exact(scene):
    pos, mask = scene
    c = pos.astype(np.float32) - np.float32(2500.5)
    c[~mask] = -3e7
    ji, jd = jax_window(jnp.asarray(c), jnp.asarray(mask), 50, window=50)
    ti, td = knn_window_sorted(T(c), T(mask), 50, window=50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("k", [16, 50])
def test_brute_knn_matches_jax(scene, jax_graph, k):
    pos, mask = scene
    ji, jd = jax_graph(k)
    ti, td = (a.numpy() for a in knn(T(pos), T(mask), k))
    _check(ti, td, ji, jd, pos, mask)


def _eigen_gap(pos, mask, idx, d, radius, max_nn):
    """(λ1 − λ0) / λ2 of each row's hybrid-neighbourhood covariance, f64."""
    k = idx.shape[1]
    use = (d <= np.float32(radius) ** 2) & (np.arange(k) < max_nn)
    use &= mask[idx] & mask[:, None]
    w = use.astype(np.float64)[..., None]
    nb = (pos[idx].astype(np.float64) - pos[:, None, :]) * w
    cnt = np.maximum(w.sum(1), 1.0)
    mean = nb.sum(1) / cnt
    cov = np.einsum("nkd,nke->nde", nb, nb) / cnt[..., None]
    cov -= mean[:, None, :] * mean[:, :, None]
    ev = np.linalg.eigvalsh(cov)
    return (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30), use.sum(1)


def test_estimate_normals_matches_jax(scene, jax_graph):
    pos, mask = scene
    idx, d = jax_graph(50)
    kw = dict(radius=300.0, max_nn=50)
    jn, jc = (np.asarray(a) for a in jax_normals(
        jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(idx),
        jnp.asarray(d), **kw))
    tn, tc = (a.numpy() for a in estimate_normals(T(pos), T(mask), T(idx),
                                                  T(d), **kw))
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    flip = np.sum(jn * tn, 1) < 0
    # sign flips only where the normal is horizontal (n_z ≈ 0)
    assert np.all(np.abs(jn[flip, 2]) < 1e-5)
    tn = np.where(flip[:, None], -tn, tn)
    gap, used = _eigen_gap(pos, mask, idx, d, **kw)
    good = mask & ((used < 3) | (gap >= 0.05))
    assert good.sum() > 0.95 * mask.sum()
    np.testing.assert_allclose(tn[good], jn[good], atol=1e-5)
