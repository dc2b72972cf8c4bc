"""The port's ``knn_window`` and ``window_offsets`` against the JAX
package's, on the CPU.

Tolerance: exact, with one stated exception.  The squared distances are
equal bit for bit, and each index's d², recomputed from the positions,
equals its slot's.  The indices are equal in every slot, except among
candidates of equal d²: the JAX union ranks with an unstable sort
(``lax.sort(..., is_stable=False)``, buildingsegment_tpu/ops/knn.py:
224-229), so its order inside a run of equal d² is the sort's, not the
input's; the port orders by (d², index) on every device.  Inside such a
run the two hold the same indices, and where the run is cut by the last
slot, each side's indices are distinct candidates at that d².  The
single search (``dual=False``) ranks stably in both and is equal in
every slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.knn import (
    knn_window as jax_knn_window,
    window_offsets as jax_window_offsets,
)
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.knn import knn_window, window_offsets


@pytest.fixture(scope="module")
def cloud():
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    n = len(pts)
    cap = ((n + 1023) // 1024) * 1024
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pos, mask


def test_window_offsets():
    for w in (1, 16, 64):
        np.testing.assert_array_equal(window_offsets(w).numpy(),
                                      np.asarray(jax_window_offsets(w)))


def _recomputed_d2(pos, idx):
    p = pos.astype(np.float32)
    d = p[idx] - p[:, None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _hold(pos, mask, ja, jd, ta, td):
    np.testing.assert_array_equal(td, jd)
    assert ta.dtype == np.int32 and td.dtype == np.float32
    np.testing.assert_array_equal(_recomputed_d2(pos, ta)[mask], td[mask])
    k = ta.shape[1]
    ties = 0
    for i in np.nonzero((ja != ta).any(1))[0]:
        assert mask[i]
        for v in np.unique(jd[i]):
            a, b = ja[i][jd[i] == v], ta[i][td[i] == v]
            assert len(set(b)) == len(b) == len(a)
            if jd[i][-1] != v:  # a run inside the row: the same indices
                assert set(a) == set(b), (i, v, a, b)
        ties += 1
    # every row's indices are distinct (self only at slot 0 or as filler)
    valid = ta[mask][:, 1:]
    filler = valid == np.nonzero(mask)[0][:, None]
    assert all(len(set(r[~f])) == (~f).sum() for r, f in zip(valid, filler))
    return ties


@pytest.mark.parametrize("k,window", [(15, 32), (16, 64), (50, 64)])
def test_knn_window_dual_matches_jax(cloud, k, window):
    pos, mask = cloud
    ja, jd = jax_knn_window(jnp.asarray(pos), jnp.asarray(mask), k,
                            window=window)
    ta, td = knn_window(torch.from_numpy(pos), torch.from_numpy(mask), k,
                        window=window)
    ties = _hold(pos, mask, np.asarray(ja), np.asarray(jd), ta.numpy(),
                 td.numpy())
    assert ties < 0.01 * mask.sum()


@pytest.mark.parametrize("presorted", [False, True])
def test_knn_window_single_matches_jax(cloud, presorted):
    pos, mask = cloud
    if presorted:
        from buildingsegment_tpu_torch.core.morton import morton_argsort

        order = morton_argsort(torch.from_numpy(pos),
                               torch.from_numpy(mask)).numpy()
        pos, mask = pos[order], mask[order]
    ja, jd = jax_knn_window(jnp.asarray(pos), jnp.asarray(mask), 15,
                            window=32, presorted=presorted, dual=False)
    ta, td = knn_window(torch.from_numpy(pos), torch.from_numpy(mask), 15,
                        window=32, presorted=presorted, dual=False)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_knn_window_presorted_dual_matches_jax(cloud):
    pos, mask = cloud
    from buildingsegment_tpu_torch.core.morton import morton_argsort

    order = morton_argsort(torch.from_numpy(pos),
                           torch.from_numpy(mask)).numpy()
    pos, mask = pos[order], mask[order]
    ja, jd = jax_knn_window(jnp.asarray(pos), jnp.asarray(mask), 15,
                            window=32, presorted=True)
    ta, td = knn_window(torch.from_numpy(pos), torch.from_numpy(mask), 15,
                        window=32, presorted=True)
    _hold(pos, mask, np.asarray(ja), np.asarray(jd), ta.numpy(), td.numpy())
