"""Port stage 1 (window kNN + hybrid normals) against the JAX package.

Neighbor indices and squared distances are EXACT: the distances are the
same f32 operations, and the stable sort over the 2W slots breaks ties
by the lower slot as ``lax.top_k`` does.  Normals: the moments are the
same f32 sums in the same order, but the eigensolve's arccos/cos differ
by a few ulps between libraries (XLA itself differs between compile
contexts), which moves the eigenvector by ~ulp/gap.  So normals are
compared up to sign (a vertical wall's n_z sits at ±1e-8, where the +Z
orientation flips on an ulp) within 1e-5 on rows whose smallest two
eigenvalues are well separated (gap ≥ 5% of the largest), and within
2e-3 everywhere; curvature within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.ops.fused import (
    finish_normals as jax_finish,
    knn_normals_window_sorted as jax_fused,
)
from buildingsegment_tpu.ops.normals import (
    canonicalize_normals as jax_canon,
    eigh3x3_smallest as jax_eigh,
)
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.fused import (
    finish_normals,
    knn_normals_window_sorted,
)
from buildingsegment_tpu_torch.ops.normals import (
    canonicalize_normals,
    eigh3x3_smallest,
)


def _eigen_gap(s0, s1, s2):
    """(λ1 − λ0) / λ2 of each row's covariance, in float64."""
    safe = np.maximum(s0, 1.0)[:, None]
    mean, m = s1 / safe, s2 / safe
    c = np.empty((len(s0), 3, 3))
    for a, b, k in ((0, 0, 0), (1, 1, 1), (2, 2, 2), (0, 1, 3), (0, 2, 4),
                    (1, 2, 5)):
        c[:, a, b] = c[:, b, a] = m[:, k] - mean[:, a] * mean[:, b]
    ev = np.linalg.eigvalsh(c)
    return (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30)


@pytest.fixture(scope="module")
def stage1():
    import buildingsegment_tpu_torch.ops.fused as fused

    pts, _ = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    cap = 16384
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask), True)
    sposf = np.array(spos).astype(np.float32)
    smask = np.array(smask)
    # the pipeline's production settings: k 16, w 48, radius 100, max_nn 50
    kw = dict(window=48, radius=100.0, max_nn=50)
    j = [np.asarray(x) for x in jax_fused(jnp.asarray(sposf),
                                          jnp.asarray(smask), 16, **kw)]
    moments = {}
    orig = fused.finish_normals

    def spy(s0, s1, s2, **fkw):
        moments["s"] = [x.numpy().astype(np.float64) for x in (s0, s1, s2)]
        return orig(s0, s1, s2, **fkw)

    fused.finish_normals = spy
    try:
        t = [x.numpy() for x in knn_normals_window_sorted(
            torch.from_numpy(sposf), torch.from_numpy(smask), 16, **kw)]
    finally:
        fused.finish_normals = orig
    s0 = moments["s"][0]
    # rows with < 3 neighbors get +Z exactly; the others by their gap
    conditioned = (s0 < 3.0) | (_eigen_gap(*moments["s"]) >= 0.05)
    return j, t, smask, conditioned


def test_window_knn_exact(stage1):
    (ji, jd, _, _), (ti, td, _, _), _, _ = stage1
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_window_normals_within_tolerance(stage1):
    (_, _, jn, jc), (_, _, tn, tc), smask, conditioned = stage1
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    flip = np.sum(jn * tn, 1) < 0
    # sign flips happen only where the normal is horizontal (n_z ≈ 0)
    assert np.all(np.abs(jn[flip, 2]) < 1e-5)
    tn = np.where(flip[:, None], -tn, tn)
    np.testing.assert_allclose(tn, jn, atol=2e-3)
    good = smask & conditioned
    assert good.sum() > 0.95 * smask.sum()
    np.testing.assert_allclose(tn[good], jn[good], atol=1e-5)


def test_finish_and_eigensolve_match_jax():
    """The normal finish on identical random moments."""
    rng = np.random.default_rng(7)
    n = 4096
    d = rng.normal(0, [80.0, 60.0, 3.0], (n, 12, 3)).astype(np.float32)
    s0 = np.full(n, 12.0, np.float32)
    s0[:50] = 2.0  # too few neighbors → +Z
    s1 = d.sum(1)
    s2 = np.stack([d[..., 0] ** 2, d[..., 1] ** 2, d[..., 2] ** 2,
                   d[..., 0] * d[..., 1], d[..., 0] * d[..., 2],
                   d[..., 1] * d[..., 2]], -1).sum(1).astype(np.float32)
    jv, jc = jax_finish(jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(s2))
    tv, tc = finish_normals(torch.from_numpy(s0), torch.from_numpy(s1),
                            torch.from_numpy(s2))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    cov = rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = cov @ cov.transpose(0, 2, 1)
    jv, je = jax_eigh(jnp.asarray(cov))
    tv, te = eigh3x3_smallest(torch.from_numpy(cov))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(tv.numpy() * np.asarray(jv), 1)),
                               1.0, atol=1e-5)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[::7, 0] = 0.0
    np.testing.assert_array_equal(
        canonicalize_normals(torch.from_numpy(nrm)).numpy(),
        np.asarray(jax_canon(jnp.asarray(nrm))),
    )
