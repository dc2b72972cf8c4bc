"""The port's ``--trace`` and ``--dump-stages`` against the JAX
package's, on the CPU (``--golden``: tests/test_torch_cli_golden.py).

* ``--trace DIR`` exits 0 and writes DIR/trace.json with the pipeline's
  stage spans.
* ``--dump-stages F`` exits 0 and writes the JAX package's keys, dtypes
  and shapes; ``dump_stages(include_graph=True)`` adds the graph arrays:
  neighbour indices and squared distances bit for bit, normals and
  curvature at the f32 tolerance of tests/test_torch_fused.py (up to
  sign within 2e-3, curvature within 1e-5).
* The flags are read in the JAX package's order: ``--batch`` first,
  which ignores ``--golden``.
"""

import json
import os

import numpy as np
import pytest

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.pipeline import (
    dump_stages as jax_dump_stages,
    segment_file as jax_segment_file,
)
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu_torch.cli import main
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.pipeline import dump_stages, segment_file
from buildingsegment_tpu_torch.profiling import TRACE_FILE
from buildingsegment_tpu_torch.utils import make_building_cloud


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    pts, truth = make_building_cloud(
        seed=2, spacing_mm=200.0, width_mm=4000.0, depth_mm=3000.0,
        wall_h_mm=2500.0, ridge_h_mm=3500.0,
    )
    path = str(tmp_path_factory.mktemp("flags") / "scan.ply")
    write_ply(HostPointCloud(positions=pts), path, position_scale=0.001)
    return path, pts, truth


def test_trace_flag(scan, tmp_path, capsys):
    src, pts, _ = scan
    out = tmp_path / "out.ply"
    rc = main([f"-a={src}", f"-s={out}", "--trace", str(tmp_path / "t")],
              device="cpu")
    assert rc == 0 and read_ply(str(out)).count == len(pts)
    with open(tmp_path / "t" / TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"knn", "normals", "segmentation", "colorize"} <= names


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_dump_stages_flag_matches_jax_keys(scan, tmp_path, capsys):
    src, _, _ = scan
    rc = main([f"-a={src}", f"-s={tmp_path / 'out.ply'}", "--dump-stages",
               str(tmp_path / "s.npz")], device="cpu")
    assert rc == 0
    got = _npz(tmp_path / "s.npz")
    jax_out = jax_segment_file(src, str(tmp_path / "jax.ply"))
    jax_dump_stages(jax_out, str(tmp_path / "jax.npz"))
    want = _npz(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    for k in ("positions", "bbox_min", "num_planes", "plane_counts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bij_agreement(want["plane_idx"], got["plane_idx"]) >= 0.99


def test_dump_stages_graph_matches_jax(scan, tmp_path):
    src, _, _ = scan
    cfg = PipelineConfig(knn_method="window")
    out = segment_file(src, str(tmp_path / "o.ply"), cfg, device="cpu")
    dump_stages(out, str(tmp_path / "g.npz"), include_graph=True,
                config=cfg, device="cpu")
    jcfg = JaxPipelineConfig(knn_method="window")
    jax_out = jax_segment_file(src, str(tmp_path / "j.ply"), jcfg)
    jax_dump_stages(jax_out, str(tmp_path / "jg.npz"), include_graph=True,
                    config=jcfg)
    got, want = _npz(tmp_path / "g.npz"), _npz(tmp_path / "jg.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    for k in ("positions", "neigh_idx", "neigh_sq_dist"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["curvature"], want["curvature"],
                               atol=1e-5)
    flip = np.sum(got["normals"] * want["normals"], 1) < 0
    tn = np.where(flip[:, None], -got["normals"], got["normals"])
    np.testing.assert_allclose(tn, want["normals"], atol=2e-3)


def test_batch_runs_before_golden(scan, tmp_path, capsys):
    src, _, _ = scan
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    os.symlink(src, in_dir / "a.ply")
    rc = main(["--batch", str(in_dir), str(tmp_path / "out"), "--golden"],
              device="cpu")
    assert rc == 0
    assert capsys.readouterr().out.startswith("1 scans, ")
    assert os.listdir(tmp_path / "out") == ["a.ply"]
