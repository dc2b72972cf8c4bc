"""The port's multi-scan pipeline (``segment_files``) on the CPU.

``_bucket_capacity`` equals the JAX package's.  ``segment_files`` on two
small scans with ``render_dir``: each output equals the port's
``segment_cloud`` of the same scan at the same bucketed capacity (labels,
plane counts and diagnostics exactly; the plane normals and centers
within 1e-6, because PyTorch's CPU reductions split their sums by the
OpenMP threads left free, and the writer thread's work on the CPU takes
some), each labeled PLY
reads back with its point count and colors, and each scan's directory
holds the three PNGs, byte-equal to ``render_ortho_views`` of the
single-scan output.
"""

import dataclasses
import os

import numpy as np
import pytest

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.pipeline import _bucket_capacity as jax_bucket
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.pipeline import (
    _bucket_capacity,
    segment_cloud,
    segment_files,
)
from buildingsegment_tpu_torch.raster.ortho import render_ortho_views
from buildingsegment_tpu_torch.utils import bij_agreement, make_building_cloud

# the multigrid window path at a normal radius that suits 250 mm spacing
_CFG = PipelineConfig(knn_method="window", normal_radius=400.0)
_PNGS = ("平均高度.png", "像素数量.png", "像素数量+高度.png")


@pytest.mark.parametrize("pad", [512, 1024])
@pytest.mark.parametrize("n", [1, 100, 777, 1000, 1025, 4097, 300_000,
                               1_082_304, 2**21])
def test_bucket_capacity_matches_jax(n, pad):
    got = _bucket_capacity(n, PipelineConfig(pad_to_multiple=pad))
    assert got == jax_bucket(n, JaxPipelineConfig(pad_to_multiple=pad))
    assert got >= n and got % pad == 0


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    paths, truths = [], []
    for i, seed in enumerate((1, 2)):
        pts, truth = make_building_cloud(seed=seed, spacing_mm=250.0,
                                         noise_mm=10.0)
        path = str(d / f"scan{i}.ply")
        write_ply(HostPointCloud(positions=pts), path, position_scale=0.001)
        paths.append(path)
        truths.append(truth)
    return paths, truths


def test_segment_files_matches_segment_cloud(scans, tmp_path):
    paths, truths = scans
    outs = [str(tmp_path / os.path.basename(p)) for p in paths]
    render = str(tmp_path / "render")
    results = segment_files(paths, outs, _CFG, device="cpu",
                            render_dir=render)
    assert len(results) == 2
    for src, dst, truth, r in zip(paths, outs, truths, results):
        cloud = read_ply(src, position_scale=_CFG.position_scale)
        cap = _bucket_capacity(cloud.count, _CFG)
        one = segment_cloud(
            cloud, dataclasses.replace(_CFG, pad_to_multiple=cap),
            device="cpu")
        assert r.num_planes == one.num_planes >= 5
        np.testing.assert_array_equal(r.plane_idx, one.plane_idx)
        np.testing.assert_array_equal(r.plane_counts, one.plane_counts)
        np.testing.assert_allclose(r.plane_normals, one.plane_normals,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r.plane_centers, one.plane_centers,
                                   rtol=1e-6)
        assert r.diagnostics == one.diagnostics
        # the writer freed the scan's device tensors
        assert r.device_shifted is None and r.device_mask is None
        assert one.device_shifted.shape == (cap, 3)
        assert bij_agreement(truth, r.plane_idx) > 0.9
        back = read_ply(dst)
        assert back.count == cloud.count
        np.testing.assert_array_equal(back.colors, r.cloud.colors)
        assert {"write_ply", "render", "total"} <= set(r.timings)
        # the scan's PNGs equal a single-scan render of the same output
        scan_dir = os.path.join(
            render, os.path.splitext(os.path.basename(src))[0])
        assert sorted(os.listdir(scan_dir)) == sorted(_PNGS)
        single = render_ortho_views(one, str(tmp_path / "single"))
        for name in _PNGS:
            with open(os.path.join(scan_dir, name), "rb") as f, \
                    open(single[name], "rb") as g:
                assert f.read() == g.read(), name


def test_segment_files_without_render(scans, tmp_path):
    paths, _ = scans
    outs = [str(tmp_path / f"o{i}.ply") for i in range(len(paths))]
    results = segment_files(paths[::-1], outs, _CFG, device="cpu")
    assert [r.cloud.count for r in results] == [
        read_ply(p).count for p in paths[::-1]]
    assert all("render" not in r.timings for r in results)
    assert sorted(os.listdir(tmp_path)) == ["o0.ply", "o1.ply"]


def test_segment_files_missing_input(scans, tmp_path):
    paths, _ = scans
    with pytest.raises(FileNotFoundError):
        segment_files([paths[0], str(tmp_path / "none.ply")],
                      [str(tmp_path / "a.ply"), str(tmp_path / "b.ply")],
                      _CFG, device="cpu")
