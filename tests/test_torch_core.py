"""Port core ops against the JAX package: bbox shift, Morton sort (both
branches), unsort, prefix sum, colorize — all EXACT (integer ops and a
permutation)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.core.quantize import shift_to_origin as jax_shift
from buildingsegment_tpu.ops.prefix import prefix_sum_i32 as jax_prefix
from buildingsegment_tpu.seg.colorize import colorize_planes as jax_colorize
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.core.morton import morton_sort, unsort_labels
from buildingsegment_tpu_torch.core.pointset import PAD_COORD, PointBatch
from buildingsegment_tpu_torch.core.quantize import shift_to_origin
from buildingsegment_tpu_torch.ops.prefix import prefix_sum_i32
from buildingsegment_tpu_torch.seg.colorize import colorize_planes


def _padded(offset, cap=16384):
    pts, _ = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    batch = PointBatch.upload(pts + np.asarray(offset, np.int32), cap)
    return batch.positions.numpy(), batch.mask.numpy()


def test_upload_pads_with_sentinel():
    pos, mask = _padded((0, 0, 0))
    n = int(mask.sum())
    assert pos.shape == (16384, 3) and pos.dtype == np.int32
    assert mask[:n].all() and not mask[n:].any()
    assert (pos[n:] == PAD_COORD).all()


@pytest.mark.parametrize(
    "offset,small",
    [
        ((0, 0, 0), True),            # one int64 key
        ((0, 0, 0), False),           # general branch, resid ≡ 0
        # coordinates beyond 2^20: the residual word leads the order
        ((1 << 20, 3 << 20, 5), False),
    ],
)
def test_shift_and_morton_sort_exact(offset, small):
    pos, mask = _padded((7, 11, 13))
    if offset != (0, 0, 0):
        # spread part of the cloud past 2^20 mm on x and y
        far = np.arange(len(pos)) % 3 == 0
        pos = pos.copy()
        pos[far & mask] += np.asarray(offset, np.int32)
    j_sh, j_lo, j_hi = jax_shift(jnp.asarray(pos), jnp.asarray(mask))
    t_sh, t_lo, t_hi = shift_to_origin(torch.from_numpy(pos),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(t_sh.numpy(), np.asarray(j_sh))
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    js, jm, jo = jax_morton_sort(j_sh, jnp.asarray(mask), small)
    ts, tm, to = morton_sort(t_sh, torch.from_numpy(mask), small)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_unsort_labels_inverts_order():
    rng = np.random.default_rng(0)
    order = torch.from_numpy(rng.permutation(1000))
    labels = torch.from_numpy(rng.integers(-1, 50, 1000).astype(np.int32))
    out = unsort_labels(order, labels)
    np.testing.assert_array_equal(out[order].numpy(), labels.numpy())


def test_prefix_sum_exact():
    x = np.random.default_rng(1).integers(0, 2, 70001).astype(np.int32)
    np.testing.assert_array_equal(
        prefix_sum_i32(torch.from_numpy(x)).numpy(),
        np.asarray(jax_prefix(jnp.asarray(x))),
    )


def test_colorize_matches_jax():
    idx = np.random.default_rng(2).integers(-1, 40, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        colorize_planes(idx, 39), jax_colorize(idx, 39)
    )
