"""The port's ``--golden`` against the JAX package's, on the CPU.

* ``golden_segment`` equals the JAX package's bit for bit on the same
  kNN lists and normals;
* the whole ``--golden`` run (each package's own kNN and normals) is
  held to the end-to-end contract of tests/test_forced_tpu_path.py — the
  same plane count, cross agreement ≥ 0.99 and truth agreement within
  0.01 — on the labels its PLY's colors encode;
* a missing input exits 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from buildingsegment_tpu.cli import _run_golden as jax_run_golden
from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.ops.knn import knn as jax_knn
from buildingsegment_tpu.ops.normals import (
    estimate_normals as jax_estimate_normals,
)
from buildingsegment_tpu.seg.golden import golden_segment as jax_golden
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu_torch.cli import main
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.seg.colorize import msvc_rand_colors
from buildingsegment_tpu_torch.seg.golden import golden_segment
from buildingsegment_tpu_torch.utils import make_building_cloud


@pytest.fixture(scope="module")
def small_scan(tmp_path_factory):
    """The 8,980-point house at 120 mm spacing: the golden oracle finds
    six planes there."""
    pts, truth = make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )
    path = str(tmp_path_factory.mktemp("golden") / "small.ply")
    write_ply(HostPointCloud(positions=pts), path, position_scale=0.001)
    return path, pts, truth


@pytest.fixture(scope="module")
def golden_inputs(small_scan):
    """The scan's exact kNN lists and normals, from the JAX package."""
    _, pts, _ = small_scan
    pts = pts - pts.min(axis=0)
    cap = ((len(pts) + 1023) // 1024) * 1024
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    idx, d = jax_knn(jnp.asarray(pos), jnp.asarray(mask), k=50)
    nrm, _ = jax_estimate_normals(jnp.asarray(pos), jnp.asarray(mask), idx,
                                  d, radius=100.0, max_nn=50)
    n = len(pts)
    return (pts, np.asarray(nrm)[:n].astype(np.float64),
            np.asarray(idx)[:n, :15])


@pytest.mark.parametrize("kw", [
    dict(), dict(th_point_count=20), dict(th_thickness=120.0,
                                          th_normal_cos=0.95),
], ids=["reference", "small_planes", "strict"])
def test_golden_segment_bit_for_bit(golden_inputs, kw):
    pts, nrm, idx = golden_inputs
    a_idx, a_planes = jax_golden(pts, nrm, idx, k=15, **kw)
    b_idx, b_planes = golden_segment(pts, nrm, idx, k=15, **kw)
    np.testing.assert_array_equal(b_idx, a_idx)
    assert len(b_planes) == len(a_planes)
    for a, b in zip(a_planes, b_planes):
        assert a.id == b.id and a.point_idx == b.point_idx
        np.testing.assert_array_equal(b.normal, a.normal)
        np.testing.assert_array_equal(b.center, a.center)
    assert len(b_planes) >= (5 if not kw else 1)


def _labels_from_colors(colors, planes):
    """Plane ids from the golden PLY's colors (the MSVC rand() table)."""
    table = msvc_rand_colors(planes)
    key = lambda c: (c[:, 0].astype(np.int64) << 16) | (
        c[:, 1].astype(np.int64) << 8) | c[:, 2]
    lookup = {int(v): i + 1 for i, v in enumerate(key(table))}
    return np.array([lookup.get(int(v), -1) for v in key(colors & 0xFF)])


def test_golden_flag_matches_jax(small_scan, tmp_path, capsys):
    src, pts, truth = small_scan
    assert jax_run_golden(src, str(tmp_path / "jax.ply"),
                          JaxPipelineConfig()) == 0
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    rc = main([f"-a={src}", f"-s={tmp_path / 'port.ply'}", "--golden"],
              device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0 and "(golden oracle)" in line
    planes_a = int(jax_line.split("→ ")[1].split()[0])
    planes_b = int(line.split("→ ")[1].split()[0])
    assert planes_b == planes_a >= 5
    a = read_ply(str(tmp_path / "jax.ply"))
    b = read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(b.positions, a.positions)
    la = _labels_from_colors(a.colors, planes_a)
    lb = _labels_from_colors(b.colors, planes_b)
    assert bij_agreement(la, lb) >= 0.99
    assert abs(bij_agreement(truth, la) - bij_agreement(truth, lb)) < 0.01


def test_golden_missing_input(tmp_path, capsys):
    rc = main([f"-a={tmp_path / 'none.ply'}", f"-s={tmp_path / 'o.ply'}",
               "--golden"], device="cpu")
    assert rc == 1 and "cannot open" in capsys.readouterr().err
