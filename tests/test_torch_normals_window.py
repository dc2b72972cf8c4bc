"""The port's ``estimate_normals_window`` against the JAX package's, on
the CPU, and its card path's kernel mode against the Pallas kernel.

* The plain version of the stats kernel (#3) in radius-only mode — k = 1
  (no order statistic), w = 64, no cap — is held against the Pallas
  ``_stats_kernel`` run in interpret mode at the same settings, as
  tests/test_torch_stats.py does for the pipeline's mode: ``kth_sq_dist``
  all 0 and the moment sums bit for bit.
* ``estimate_normals_window`` on a CPU tensor mirrors the JAX package's
  XLA form (one pass per offset −W..W, self included), and its moments
  equal those of the card path's plain version bit for bit.
* Normals and curvature, from equal or near-equal moments, go through
  two closed-form eigensolves (XLA's and PyTorch's trigonometric
  functions and product contractions differ in the last bits).  The
  tolerance follows the eigenvalue gap, computed in float64 from the
  moments: where the two smallest eigenvalues lie more than 1% of their
  sum apart, |n·n'| ≥ 1 − 1e-5 and curvature within 1e-4; where they lie
  closer (a near-degenerate neighbourhood: the trigonometric solution
  merges the two and the normal may turn anywhere in their plane),
  curvature within 0.01, the bound the gap itself sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.ops.fused import finish_normals as jax_finish
from buildingsegment_tpu.ops.normals import (
    estimate_normals_window as jax_estimate_normals_window,
)
from buildingsegment_tpu.ops.stats_sweep import fused_stats_sweep
from buildingsegment_tpu.ops.window_sweep import make_slab
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.ops.fused import finish_normals
from buildingsegment_tpu_torch.ops.normals import estimate_normals_window
from buildingsegment_tpu_torch.ops.stats_sweep import stats_sweep_reference


def _sorted(pts, cap):
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    return np.array(spos, np.float32), np.array(smask)


@pytest.fixture(scope="module")
def dense_cloud():
    """A small house at 60 mm spacing (13,982 points): ~7 neighbours in
    a 100 mm ball."""
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=60.0, width_mm=3000.0, depth_mm=2500.0,
        wall_h_mm=2000.0, ridge_h_mm=2800.0,
    )
    return _sorted(pts, ((len(pts) + 1023) // 1024) * 1024)


def _cols(spos):
    t = torch.from_numpy(spos)
    return tuple(t[:, d].contiguous() for d in range(3))


def _angles_deg(a, b):
    cos = np.clip(np.abs(np.sum(np.asarray(a) * np.asarray(b), -1)), 0, 1)
    return np.degrees(np.arccos(cos))


def _hold_finish(s0, s1, s2, smask, n, c, jn, jc):
    """Normals and curvature against JAX's under the eigenvalue-gap rule
    (module docstring)."""
    s0, s1, s2 = (np.asarray(x, np.float64) for x in (s0, s1, s2))
    safe = np.maximum(s0, 1.0)
    mean = s1 / safe[:, None]
    m = s2 / safe[:, None]
    cov = np.empty((len(s0), 3, 3))
    for a, b, col in ((0, 0, 0), (1, 1, 1), (2, 2, 2), (0, 1, 3), (0, 2, 4),
                      (1, 2, 5)):
        cov[:, a, b] = cov[:, b, a] = m[:, col] - mean[:, a] * mean[:, b]
    ev = np.linalg.eigvalsh(cov)
    clear = (ev[:, 1] - ev[:, 0]) > 0.01 * np.maximum(ev.sum(1), 1e-12)
    held = np.asarray(smask) & (s0 >= 3) & clear
    near = np.asarray(smask) & (s0 >= 3) & ~clear
    assert held.sum() > 0.8 * np.asarray(smask).sum()
    n, c, jn, jc = (np.asarray(x) for x in (n, c, jn, jc))
    dots = np.abs(np.sum(n * jn, 1))
    assert dots[held].min() >= 1 - 1e-5, dots[held].min()
    np.testing.assert_allclose(c[held], jc[held], atol=1e-4)
    np.testing.assert_allclose(c[near], jc[near], atol=1e-2)
    rest = ~(held | near)  # padding and balls of < 3 points: exact
    np.testing.assert_array_equal(n[rest], jn[rest])
    np.testing.assert_array_equal(c[rest], jc[rest])


def test_radius_only_stats_match_pallas_kernel(dense_cloud):
    spos, smask = dense_cloud
    w = 64
    slab = make_slab(
        [jnp.asarray(spos[:, d]) for d in range(3)]
        + [jnp.asarray(smask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0], w, 256, rows_out=8,
    )
    jdk, js0, js1, js2 = fused_stats_sweep(
        slab, spos.shape[0], k=1, w=w, tile=256, radius=100.0, max_nn=None,
        interpret=True,
    )
    dk, s0, s1, s2 = stats_sweep_reference(
        _cols(spos), torch.from_numpy(smask), k=1, w=w, radius=100.0,
        max_nn=None,
    )
    assert not dk.any() and not np.asarray(jdk)[smask].any()
    for a, b in ((s0, js0), (s1, js1), (s2, js2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert s0.numpy()[smask].mean() > 5  # real neighbourhoods
    jn, jc = jax_finish(js0, js1, js2)
    n, c = finish_normals(s0, s1, s2)
    assert np.percentile(_angles_deg(n.numpy(), jn)[smask], 99) < 0.2
    _hold_finish(s0, s1, s2, smask, n, c, jn, jc)


def test_estimate_normals_window_matches_jax(dense_cloud):
    radius, window = 100.0, 64
    spos, smask = dense_cloud
    jn, jc = jax_estimate_normals_window(jnp.asarray(spos),
                                         jnp.asarray(smask), radius=radius,
                                         window=window)
    jn, jc = np.asarray(jn), np.asarray(jc)
    n, c = estimate_normals_window(torch.from_numpy(spos),
                                   torch.from_numpy(smask), radius=radius,
                                   window=window)
    assert n.dtype == torch.float32 and tuple(n.shape) == jn.shape
    _dk, s0, s1, s2 = stats_sweep_reference(
        _cols(spos), torch.from_numpy(smask), k=1, w=window, radius=radius,
        max_nn=None)
    _hold_finish(s0, s1, s2, smask, n, c, jn, jc)


def test_card_path_moments_equal_cpu_path(dense_cloud, monkeypatch):
    """The kernel's plain version (``stats_sweep`` at k = 1, no cap) and
    the CPU path's per-offset passes give the same moments."""
    from buildingsegment_tpu_torch.ops import fused

    spos, smask = dense_cloud
    seen = []
    finish = fused.finish_normals

    def spy(s0, s1, s2, orient_z=True):
        seen.append((s0, s1, s2))
        return finish(s0, s1, s2, orient_z=orient_z)

    monkeypatch.setattr(fused, "finish_normals", spy)
    estimate_normals_window(torch.from_numpy(spos), torch.from_numpy(smask),
                            radius=100.0, window=64)
    _dk, s0, s1, s2 = stats_sweep_reference(
        _cols(spos), torch.from_numpy(smask), k=1, w=64, radius=100.0,
        max_nn=None)
    for a, b in zip(seen[0], (s0, s1, s2)):
        assert torch.equal(a, b)
