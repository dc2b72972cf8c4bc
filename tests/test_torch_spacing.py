"""The spacing hint measured on the device from stage 1's Morton order.

Stage 1 counts the live rows and the occupied 512 mm cells of the
Morton-sorted cloud (``pipeline._cell_counts``); the host turns the two
numbers into the hint (``pipeline._spacing_hint``).  Both are held to
the host's own ``np.unique`` count and to
``spacing_bucket_mm(estimate_spacing_mm(...))`` on both branches of
``morton_sort``, with padding in every batch.  ``segment_cloud`` with
the measured hint labels as a run given the host's hint beforehand, and
reports the count in its diagnostics.
"""

import dataclasses

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.core.morton import morton_sort, occupied_cells
from buildingsegment_tpu_torch.core.pointset import PointBatch
from buildingsegment_tpu_torch.core.quantize import (
    estimate_spacing_mm,
    shift_to_origin,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import (
    _cell_counts,
    _spacing_hint,
    segment_cloud,
)
from buildingsegment_tpu_torch.utils import make_building_cloud

_SMALL_HOUSE = dict(width_mm=5000.0, depth_mm=4000.0, wall_h_mm=3000.0,
                    ridge_h_mm=4000.0)


def _house(spacing_mm):
    return make_building_cloud(seed=3, spacing_mm=spacing_mm,
                               **_SMALL_HOUSE)[0]


def _far():
    """A third of the house moved past 2^20 mm on x and y: the residual
    word leads the order."""
    pts = _house(150.0)
    far = np.arange(len(pts)) % 3 == 0
    pts[far] += np.asarray([1 << 20, 3 << 20, 5], np.int32)
    return pts


def _duplicates():
    pts = _house(300.0)
    return np.concatenate([pts, pts[::2], pts[:7]])


def _boundaries():
    """Points on and either side of the 512 mm cell faces (511, 512,
    513, ...), the origin among them so the shift keeps the faces."""
    rng = np.random.default_rng(7)
    faces = rng.integers(0, 8, size=(600, 3)) * 512
    pts = np.maximum(faces + rng.integers(-1, 2, size=(600, 3)), 0)
    return np.concatenate([np.zeros((1, 3), np.int64), pts]).astype(np.int32)


_CLOUDS = {
    "house_25mm": lambda: _house(25.0),
    "house_150mm": lambda: _house(150.0),
    "house_300mm": lambda: _house(300.0),
    "far_axes": _far,
    "duplicates": _duplicates,
    "one_point": lambda: np.asarray([[12_345, 678, 9]], np.int32),
    "no_points": lambda: np.zeros((0, 3), np.int32),
    "mostly_padding": lambda: _house(300.0)[:100],
    "cell_boundaries": _boundaries,
}
_CASES = [(name, small) for name in _CLOUDS for small in (True, False)
          if not (small and name == "far_axes")]


def _host_occupied(pts):
    """The oracle: distinct 512 mm cells of the shifted cloud."""
    if len(pts) == 0:
        return 0
    q = (pts.astype(np.int64) - pts.min(axis=0)) // 512
    return len(np.unique(q, axis=0))


@pytest.mark.parametrize("name,small", _CASES,
                         ids=[f"{n}-{'small' if s else 'resid'}"
                              for n, s in _CASES])
def test_device_count_matches_host(name, small):
    pts = _CLOUDS[name]()
    n = len(pts)
    # at least a quarter of every batch is padding; "mostly_padding" 4×
    cap = (n + n // 4) // 128 * 128 + 128
    if name == "mostly_padding":
        cap = 4 * 128
    batch = PointBatch.upload(pts, cap, device="cpu")
    shifted, _lo, _hi = shift_to_origin(batch.positions, batch.mask)
    spos, smask, _order = morton_sort(shifted, batch.mask, small)
    live, occupied = _cell_counts(spos, smask).tolist()
    assert live == n
    assert occupied == _host_occupied(pts)
    hint = _spacing_hint(live, occupied)
    if n:
        assert hint == spacing_bucket_mm(estimate_spacing_mm(pts))
    else:
        assert hint is None


def test_coarse_cells_are_refused():
    """Above 2^20 mm cells the residual word's axes split a cell."""
    spos = torch.zeros((4, 3), dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.bool)
    assert int(occupied_cells(spos, mask, 20)) == 1
    with pytest.raises(ValueError, match="cell_bits"):
        occupied_cells(spos, mask, 21)


def test_segment_cloud_measures_the_host_hint():
    """The measured hint labels the scan as the host's hint given
    beforehand does; a hint set by the user is used as given, and no
    count is made."""
    pts, _ = make_building_cloud(seed=5, spacing_mm=120.0, **_SMALL_HOUSE)
    cloud = HostPointCloud(positions=pts)
    cfg = PipelineConfig(knn_method="window")
    measured = segment_cloud(cloud, cfg, device="cpu")
    host_hint = spacing_bucket_mm(estimate_spacing_mm(pts))
    given = segment_cloud(
        cloud, dataclasses.replace(cfg, spacing_hint_mm=host_hint),
        device="cpu")
    assert measured.num_planes == given.num_planes >= 5
    np.testing.assert_array_equal(measured.plane_idx, given.plane_idx)
    np.testing.assert_array_equal(measured.plane_counts, given.plane_counts)
    np.testing.assert_array_equal(measured.plane_normals,
                                  given.plane_normals)
    np.testing.assert_array_equal(measured.plane_centers,
                                  given.plane_centers)
    np.testing.assert_array_equal(measured.cloud.colors, given.cloud.colors)
    assert measured.diagnostics["occupied_cells_512mm"] == _host_occupied(pts)
    assert measured.diagnostics["occupied_cells_512mm"] > 0
    assert given.diagnostics["occupied_cells_512mm"] == 0
    assert "stage1.cells" in measured.timings
    assert "stage1.cells" not in given.timings
    assert {k: v for k, v in measured.diagnostics.items()
            if k != "occupied_cells_512mm"} == {
        k: v for k, v in given.diagnostics.items()
        if k != "occupied_cells_512mm"}
