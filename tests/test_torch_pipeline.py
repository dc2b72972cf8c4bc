"""The port's window path end to end against the JAX package, and the
import boundary.

``segment_cloud`` with ``knn_method="window"`` on both packages (CPU),
single-level (``seg_group=1``) and multigrid (the default
``seg_group=4``, ``seg_levels=2``): the contract of
tests/test_forced_tpu_path.py — the same plane count, cross agreement
≥ 0.99 and truth agreement within 0.01.  ``segment_file`` round-trips a
binary PLY.  Multi-scan ``segment_files`` refuses input and output
lists of different lengths (its runs: tests/test_torch_multiscan.py; the
exact-kNN methods: tests/test_torch_classic.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.pipeline import segment_cloud as jax_segment_cloud
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.core.quantize import (
    estimate_spacing_mm,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.pipeline import (
    segment_cloud,
    segment_file,
    segment_files,
)
from buildingsegment_tpu_torch.seg.coarse import FINALIZE_COUNTERS

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SINGLE = dict(knn_method="window", seg_group=1, pad_to_multiple=2048)
# the default configuration, with the window path forced on a scene below
# the 65,536-point "auto" threshold
_MULTIGRID = dict(knn_method="window")
_CFG = PipelineConfig(**_SINGLE)


@pytest.fixture(scope="module")
def scene():
    return make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )


@pytest.mark.parametrize("cfg", [_SINGLE, _MULTIGRID],
                         ids=["single_level", "multigrid"])
def test_segment_cloud_matches_jax(scene, cfg):
    pts, truth = scene
    a = jax_segment_cloud(JaxHostPointCloud(positions=pts),
                          JaxPipelineConfig(**cfg))
    b = segment_cloud(HostPointCloud(positions=pts), PipelineConfig(**cfg),
                      device="cpu")
    assert b.num_planes == a.num_planes >= 5
    assert b.num_sweeps > 0
    assert bij_agreement(a.plane_idx, b.plane_idx) >= 0.99
    ag_a = bij_agreement(truth, a.plane_idx)
    ag_b = bij_agreement(truth, b.plane_idx)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)
    np.testing.assert_array_equal(b.cloud.positions, a.cloud.positions)
    np.testing.assert_array_equal(b.bbox_min, a.bbox_min)
    np.testing.assert_array_equal(b.plane_counts, a.plane_counts)
    np.testing.assert_allclose(b.plane_normals, a.plane_normals, atol=1e-4)
    # the port reports the occupied 512 mm cells its hint was measured
    # from, the hint and, on the multigrid solve, the finalize's counters
    # (tests/test_torch_block_finalize.py), its unlabeled points among them
    cells = len(np.unique((pts - pts.min(axis=0)) // 512, axis=0))
    keys = FINALIZE_COUNTERS + ("finalize_rows",)
    finalize = {k: b.diagnostics[k] for k in keys if k in b.diagnostics}
    assert len(finalize) == (len(keys) if cfg is _MULTIGRID else 0)
    if finalize:
        assert finalize["unlabeled_points"] == int((b.plane_idx == -1).sum())
    assert b.diagnostics == dict(
        a.diagnostics, occupied_cells_512mm=cells,
        spacing_hint_mm=spacing_bucket_mm(estimate_spacing_mm(pts)),
        **finalize)


def test_segment_file_round_trip(scene, tmp_path):
    pts, _ = scene
    src, dst = str(tmp_path / "in.ply"), str(tmp_path / "out.ply")
    # metres in the file, ×1000 → mm on read (the reference's contract)
    write_ply(HostPointCloud(positions=pts), src, position_scale=0.001)
    out = segment_file(src, dst, _CFG, device="cpu")
    with open(dst, "rb") as f:
        head = f.read(400).split(b"end_header")[0].decode()
    assert "binary_little_endian" in head
    assert f"element vertex {len(pts)}" in head
    back = read_ply(dst)
    np.testing.assert_array_equal(back.positions, out.cloud.positions)
    np.testing.assert_array_equal(back.colors, out.cloud.colors)
    labeled = out.plane_idx > 0
    assert (back.colors[labeled] >= 55).all()
    assert (back.colors[~labeled] == 0).all()
    assert len(np.unique(back.colors[labeled], axis=0)) == out.num_planes


def test_multigrid_config_runs(scene):
    """The multigrid configuration (seg_group=4, seg_levels=2), which the
    first slice refused, runs and labels the scene's planes."""
    pts, truth = scene
    out = segment_cloud(
        HostPointCloud(positions=pts),
        PipelineConfig(knn_method="window", seg_group=4, seg_levels=2),
        device="cpu",
    )
    assert out.num_planes >= 5
    assert "mg.finalize" in out.timings and "stage1" in out.timings
    assert bij_agreement(truth, out.plane_idx) > 0.5


def test_multiscan_raises():
    with pytest.raises(ValueError, match="2 inputs but 1 outputs"):
        segment_files(["a.ply", "b.ply"], ["c.ply"], device="cpu")


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in jax (the
    machine with the card has none) or any module of the JAX package
    (the port keeps its own copies of the host modules)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import buildingsegment_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('raster', 'raster.ortho', 'raster.contours', 'io.png',\n"
        "          'io.obj', 'ops.scatter', 'ops.segsum', 'ops.stats_mxu',\n"
        "          'cli', 'profiling', 'seg.golden', 'native.binding',\n"
        "          'core.pointset', 'dist', 'dist.mesh', 'dist.halo',\n"
        "          'dist.sharded'):\n"
        "    assert 'buildingsegment_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'buildingsegment_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    path = os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p
    )
    env = dict(os.environ, PYTHONPATH=path)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
