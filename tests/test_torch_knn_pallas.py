"""The port's ``knn_pallas`` against the JAX package's Pallas kernel (CPU).

On the CPU ``knn_pallas`` runs ``_prepare``, the plain version
``knn_exact_reference`` and ``_finish``; it is held against JAX's
``knn_pallas`` in interpret mode (default and the opt-in resident
variant) at k = 16 and k = 50 by tests/test_torch_knn.py's rule
(``_check``: distances within JAX's oracle tolerance, indices equal but
at near ties at the cut, every returned d² recomputed exactly, and
scipy's ``cKDTree``), and on a subset of query rows against the full
run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_argsort as jax_argsort
from buildingsegment_tpu.ops.pallas_knn import knn_pallas as jax_pallas
from buildingsegment_tpu_torch.ops.pallas_knn import (
    _prepare,
    knn_exact_reference,
    knn_pallas,
)
from test_torch_knn import (  # noqa: F401 (the scene fixture)
    T, _check, _padded, _random, scene,
)


@pytest.mark.parametrize("k", [16, 50])
def test_knn_pallas_matches_jax_kernel(scene, k):
    pos, mask = scene
    ji, jd = (np.asarray(a) for a in jax_pallas(
        jnp.asarray(pos), jnp.asarray(mask), k=k, interpret=True))
    ti, td = (a.numpy() for a in knn_pallas(T(pos), T(mask), k))
    _check(ti, td, ji, jd, pos, mask)


def test_knn_pallas_padding_and_small_clouds():
    """tests/test_pallas_knn.py's case: 3 points in 128 rows."""
    pts = np.array([[0, 0, 0], [5, 0, 0], [0, 5, 0]], np.int32)
    pos, mask = _padded(pts, 128)
    ji, jd = (np.asarray(a) for a in jax_pallas(
        jnp.asarray(pos), jnp.asarray(mask), k=6, query_tile=128,
        cand_tile=128, interpret=True))
    ti, td = (a.numpy() for a in knn_pallas(T(pos), T(mask), 6))
    assert ti[0, 0] == 0 and set(ti[0, 1:3]) == {1, 2}
    assert (ti[0, 3:] == 0).all()  # empty slots → self
    assert (ti[3:] == np.arange(3, 128)[:, None]).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def test_knn_pallas_matches_resident_kernel(monkeypatch):
    """The opt-in VMEM-resident Pallas kernel (sub-block gating active:
    8,192 rows, 8 query tiles a step, 4 sub-blocks a candidate tile)
    computes the same function; the env is read when JAX traces, so the
    caches are cleared around it."""
    pos, mask = _random(11, 8000, 8192, 20_000)
    order = np.asarray(jax_argsort(jnp.asarray(pos), jnp.asarray(mask)))
    pos, mask = pos[order], mask[order]
    monkeypatch.setenv("BST_KNN_RESIDENT", "1")
    jax.clear_caches()
    try:
        ji, jd = (np.asarray(a) for a in jax_pallas(
            jnp.asarray(pos), jnp.asarray(mask), k=16, interpret=True))
    finally:
        monkeypatch.delenv("BST_KNN_RESIDENT")
        jax.clear_caches()
    ti, td = (a.numpy() for a in knn_pallas(T(pos), T(mask), 16))
    _check(ti, td, ji, jd, pos, mask)


def test_knn_exact_reference_rows_subset(scene):
    """The plain version on a subset of query rows (how the card check
    samples the 1M-row shape) equals those rows of the full run, and
    every row is ascending by (d², index)."""
    pos, mask = scene
    cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct, w_excl = _prepare(
        T(pos), T(mask), 16)
    args = (cols, seed_d, seed_i, visit, visit_d2, counts)
    kw = dict(qt=qt, ct=ct, w_excl=w_excl)
    full_d, full_i = knn_exact_reference(*args, **kw)
    rows = torch.cat([torch.arange(128, 256), torch.arange(8960, 9216)])
    sub_d, sub_i = knn_exact_reference(*args, rows=rows, **kw)
    assert torch.equal(sub_d, full_d[rows]) and torch.equal(sub_i, full_i[rows])
    dd, ii = full_d.numpy(), full_i.numpy()
    assert ((dd[:, 1:] > dd[:, :-1])
            | ((dd[:, 1:] == dd[:, :-1]) & (ii[:, 1:] >= ii[:, :-1]))).all()
