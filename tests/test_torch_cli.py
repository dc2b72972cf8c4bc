"""The port's CLI (buildingsegment_tpu_torch.cli) on the CPU.

The reference argv contract (``-x=path`` split on '='), a run through
``main([...], device="cpu")`` that writes a binary PLY and prints the
JSON summary, and the refusals: no ``-a=`` → rc 2, and every flag of a
path the port does not have yet → rc 2 naming its ROADMAP.md item.
"""

import json

import numpy as np
import pytest

from buildingsegment_tpu_torch.cli import main, parse_args
from buildingsegment_tpu_torch.io.ply import HostPointCloud, read_ply, write_ply
from buildingsegment_tpu_torch.utils import make_building_cloud


@pytest.fixture(scope="module")
def scan_file(tmp_path_factory):
    pts, _ = make_building_cloud(
        seed=2, spacing_mm=200.0, width_mm=4000.0, depth_mm=3000.0,
        wall_h_mm=2500.0, ridge_h_mm=3500.0,
    )
    path = str(tmp_path_factory.mktemp("cli") / "scan.ply")
    # metres in the file, ×1000 → mm on read (the reference's contract)
    write_ply(HostPointCloud(positions=pts), path, position_scale=0.001)
    return path, len(pts)


def test_parse_reference_argv():
    args, src, dst = parse_args(
        ["-a=in=1.ply", "-s=out.ply", "--knn-method", "pallas", "--knn-k",
         "12", "--th-thickness", "250", "--signed-normals", "--dedup-bits",
         "3", "--json-summary"])
    assert (src, dst) == ("in=1.ply", "out.ply")  # split on the first '='
    assert args.knn_method == "pallas" and args.knn_k == 12
    assert args.th_thickness == 250.0 and args.signed_normals
    assert args.dedup_bits == 3 and args.json_summary and not args.ascii
    _, src, dst = parse_args(["--input", "a.ply", "--output", "b.ply"])
    assert (src, dst) == ("a.ply", "b.ply")


def test_main_writes_binary_ply(scan_file, tmp_path, capsys):
    src, n = scan_file
    dst = str(tmp_path / "out.ply")
    rc = main([f"-a={src}", f"-s={dst}", "--th-point-count", "50",
               "--json-summary", "--profile"],
              device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["points"] == n and summary["planes"] >= 3
    assert "knn" in summary["timings"]  # "auto" took the exact-kNN path
    with open(dst, "rb") as f:
        head = f.read(400).split(b"end_header")[0].decode()
    assert "format binary_little_endian 1.0" in head
    assert f"element vertex {n}" in head
    back = read_ply(dst)
    labeled = (back.colors > 0).any(1)
    assert len(np.unique(back.colors[labeled], axis=0)) == summary["planes"]


def test_missing_input_is_usage_error(capsys):
    assert main(["-s=out.ply"], device="cpu") == 2
    assert "usage" in capsys.readouterr().err


def test_missing_file(tmp_path, capsys):
    rc = main([f"-a={tmp_path / 'none.ply'}", f"-s={tmp_path / 'o.ply'}"],
              device="cpu")
    assert rc == 1 and "cannot open" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--render-dir", "r"], ["--extract-contours"], ["--batch", "a", "b"],
    ["--golden"], ["--trace", "t"], ["--dump-stages", "s.npz"],
], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_exit_2(flag, capsys):
    assert main(["-a=in.ply", "-s=out.ply", *flag], device="cpu") == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "ROADMAP" in err
