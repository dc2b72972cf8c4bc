"""The port against the JAX package on the reference's scene tests.

The scenes of tests/test_scenes.py (a tilted plane, rolling terrain, a
cylinder tank on its ground, a block of houses with clutter, and the
block under the bench-candidate configurations) and of
tests/test_multibuilding.py (two houses 40 m apart whose coplanar planes
must stay apart) go through ``run_device_pipeline`` (``segment_cloud``
for the two houses) of both packages on the CPU, with test_scenes.py's
``_run`` configuration.  The contract is that of
tests/test_forced_tpu_path.py:76-86: the same plane count, cross
agreement ≥ 0.99 and truth agreement within 0.01; each scene also keeps
the property its own test asserts.

The full-size scenes are ``slow``, as tests/test_scenes.py is.  The
tier-1 cases cut each scene to 10,000-31,010 points (the tilted plane
and rolling terrain to 5 and 6 m squares, the tank to a 1.5 m radius,
3 m tall, on a 4 m ground, the block to 150 mm spacing, the two houses
to 5 × 4 m at 120 mm spacing) and pad all of them to one capacity,
32,768, so the JAX package compiles its pipeline once for the file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.pipeline import (
    run_device_pipeline as jax_run_device_pipeline,
    segment_cloud as jax_segment_cloud,
)
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.core.quantize import (
    estimate_spacing_mm,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import (
    run_device_pipeline,
    segment_cloud,
)
from buildingsegment_tpu_torch.utils.synthetic import (
    make_block_cloud,
    make_building_cloud,
    make_cylinder_cloud,
    make_terrain_cloud,
)

# tests/test_scenes.py's _run
_RUN = dict(
    k_search=50, knn_k=15, normal_radius=100.0, normal_max_nn=50,
    th_thickness=300.0, th_normal_cos=0.88, th_point_count=400,
    max_planes=4096, max_sweeps=64, knn_method="window",
    knn_window_size=64, convergence_tol=1e-5, seg_group=4, seg_levels=2,
    seg_refine_sweeps=3,
)
_TIER1_CAP = 32768


def _two_houses(spacing_mm, **house):
    a, ta = make_building_cloud(seed=1, spacing_mm=spacing_mm, noise_mm=8.0,
                                **house)
    b, tb = make_building_cloud(seed=2, spacing_mm=spacing_mm, noise_mm=8.0,
                                **house)
    b = b + np.array([40_000, 0, 0], np.int32)  # 40 m apart
    return np.concatenate([a, b]), np.concatenate([ta, tb + ta.max()])


def _run_both(pts, cap=None, **over):
    """Both packages' ``run_device_pipeline`` on the padded scene →
    (JAX labels, JAX planes, port labels, port result)."""
    n = len(pts)
    cap = cap or ((n + 1023) // 1024) * 1024
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    kw = dict(_RUN, **over)
    _, _, a = jax_run_device_pipeline(jnp.asarray(pos), jnp.asarray(mask),
                                      **kw)
    _, _, b = run_device_pipeline(torch.from_numpy(pos),
                                  torch.from_numpy(mask), **kw)
    return (np.asarray(a.plane_idx)[:n], int(a.num_planes),
            b.plane_idx.numpy()[:n], b)


def _hold(truth, la, planes_a, lb, planes_b):
    """The forced-path contract; returns the port's truth agreement."""
    assert planes_b == planes_a, (planes_a, planes_b)
    cross = bij_agreement(la, lb)
    assert cross >= 0.99, cross
    ag_a, ag_b = bij_agreement(truth, la), bij_agreement(truth, lb)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)
    return ag_b


def _members_in_band(pts, lab, seg, th=300.0, tol=1.10):
    """test_scenes.py's band rule: every plane's members lie within the
    thickness band of its final model (≥ 95%)."""
    normals = seg.plane_normal.numpy()
    centers = seg.plane_center.numpy()
    for p in range(1, seg.num_planes + 1):
        m = lab == p
        if m.any():
            d = np.abs((pts[m].astype(np.float64) - centers[p - 1])
                       @ normals[p - 1])
            assert (d <= th * tol).mean() >= 0.95, p


def _apart(pts, lab, planes):
    """test_multibuilding.py's rule: no plane spans both houses."""
    for pid in range(1, planes + 1):
        x = pts[lab == pid][:, 0]
        assert not (x.min() < 20_000 and x.max() > 35_000), pid


# scene → (builder, keyword arguments at full size, at tier-1 size)
_SCENES = {
    "tilted_plane": (make_terrain_cloud,
                     dict(seed=3, extent_mm=10_000.0, spacing_mm=50.0,
                          slope=0.15),
                     dict(extent_mm=5_000.0)),
    "rolling_terrain": (make_terrain_cloud,
                        dict(seed=3, extent_mm=10_000.0, spacing_mm=50.0,
                             slope=0.05, roll_amp_mm=400.0,
                             roll_period_mm=4_000.0),
                        dict(extent_mm=6_000.0)),
    "cylinder_tank": (make_cylinder_cloud,
                      dict(seed=2, spacing_mm=50.0,
                           ground_extent_mm=8_000.0),
                      dict(radius_mm=1_500.0, height_mm=3_000.0,
                           ground_extent_mm=4_000.0)),
    "block_clutter": (make_block_cloud,
                      dict(seed=4, nx=2, ny=1, spacing_mm=80.0,
                           clutter_frac=0.1),
                      dict(spacing_mm=150.0)),
}


def _check_scene(name, pts, truth, lb, seg, full):
    """The properties the scene's own test asserts, on the port's run
    (its truth-agreement floors at full size only)."""
    if name == "tilted_plane":
        assert seg.num_planes == 1
        assert not full or bij_agreement(truth, lb) >= 0.99
    elif name == "rolling_terrain":
        assert seg.num_planes >= 2 or (lb > 0).mean() < 0.8
        _members_in_band(pts, lb, seg)
    elif name == "cylinder_tank":
        gm = truth == 1
        labs, cnts = np.unique(lb[gm][lb[gm] > 0], return_counts=True)
        assert cnts.max() / gm.sum() >= 0.95  # the ground, one plane
        _members_in_band(pts, lb, seg)
        zs = pts[lb == labs[np.argmax(cnts)]][:, 2].astype(np.float64)
        assert np.percentile(zs - np.median(pts[gm][:, 2]), 99) < 400.0
    else:
        assert not full or bij_agreement(truth, lb) >= 0.90
        assert (lb[truth == 0] > 0).mean() <= 0.15  # clutter unlabeled


@pytest.mark.parametrize("name", list(_SCENES))
def test_scene_matches_jax_tier1(name):
    build, full, small = _SCENES[name]
    pts, truth = build(**dict(full, **small))
    la, pa, lb, seg = _run_both(pts, cap=_TIER1_CAP)
    _hold(truth, la, pa, lb, seg.num_planes)
    _check_scene(name, pts, truth, lb, seg, full=False)


def test_two_houses_match_jax_tier1():
    pts, truth = _two_houses(120.0, width_mm=5000.0, depth_mm=4000.0,
                             wall_h_mm=3000.0, ridge_h_mm=4000.0)
    la, pa, lb, seg = _run_both(pts, cap=_TIER1_CAP)
    _hold(truth, la, pa, lb, seg.num_planes)
    _apart(pts, lb, seg.num_planes)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(_SCENES))
def test_scene_matches_jax(name):
    build, full, _small = _SCENES[name]
    pts, truth = build(**full)
    la, pa, lb, seg = _run_both(pts)
    ag = _hold(truth, la, pa, lb, seg.num_planes)
    _check_scene(name, pts, truth, lb, seg, full=True)
    print(f"{name}: {len(pts)} points, {seg.num_planes} planes, truth "
          f"agreement JAX {bij_agreement(truth, la):.6f}, port {ag:.6f}")


@pytest.mark.slow
@pytest.mark.parametrize("seed_source", [None, "coarse"])
@pytest.mark.parametrize("spacing", [80.0, 150.0])
def test_block_candidate_configs_match_jax(spacing, seed_source):
    pts, truth = make_block_cloud(seed=4, nx=2, ny=1, spacing_mm=spacing,
                                  clutter_frac=0.1)
    hint = spacing_bucket_mm(estimate_spacing_mm(pts))
    la, pa, lb, seg = _run_both(
        pts, normal_radius=3.0 * spacing, knn_window_size=48, seg_levels=3,
        seg_refine_sweeps=2, seg_seed_source=seed_source,
        spacing_hint_mm=hint,
    )
    ag = _hold(truth, la, pa, lb, seg.num_planes)
    assert (lb[truth == 0] > 0).mean() <= 0.15
    print(f"block {spacing} mm, seeds {seed_source}: {len(pts)} points, "
          f"{seg.num_planes} planes, truth agreement JAX "
          f"{bij_agreement(truth, la):.6f}, port {ag:.6f}")


@pytest.mark.slow
def test_two_houses_match_jax():
    pts, truth = _two_houses(150.0)
    cfg = dict(normal_radius=500.0, pad_to_multiple=2048,
               knn_method="window")
    a = jax_segment_cloud(JaxHostPointCloud(positions=pts),
                          JaxPipelineConfig(**cfg))
    b = segment_cloud(HostPointCloud(positions=pts), PipelineConfig(**cfg),
                      device="cpu")
    ag = _hold(truth, a.plane_idx, a.num_planes, b.plane_idx, b.num_planes)
    assert 12 <= b.num_planes <= 18
    _apart(pts, b.plane_idx, b.num_planes)
    assert ag > 0.9
    print(f"two houses: {len(pts)} points, {b.num_planes} planes, truth "
          f"agreement JAX {bij_agreement(truth, a.plane_idx):.6f}, port "
          f"{ag:.6f}")
