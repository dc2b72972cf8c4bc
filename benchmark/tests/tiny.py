"""A copy of the benchmark at a size the CPU runs in seconds: the same
manifest, cells, traffic kinds, metrics and limits, with each
configuration's scenes small and the window path forced (such small
scans would resolve to exact kNN).  Used by the tests to drive whole
runs on the port's plain paths."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.harness.manifest import ROOT, load_manifest

#: each configuration's tiny scenes: small houses, dense enough that a
#: point's normal radius holds neighbours
SCENES = {
    "tls_house_25mm": {
        "spacing_mm": 60.0,
        "smallest": {"width_mm": 2000.0, "depth_mm": 1500.0,
                     "wall_h_mm": 1500.0, "ridge_h_mm": 2000.0},
        "largest": {"width_mm": 3000.0, "depth_mm": 2000.0,
                    "wall_h_mm": 2000.0, "ridge_h_mm": 2600.0}},
}

#: scenes at which the control shows: the cell's 25 mm spacing over
#: houses of 2.5 × 2 m to 3.5 × 2.5 m (50k–95k points)
CONTROL_SCENES = {
    "tls_house_25mm": {
        "spacing_mm": 25.0,
        "smallest": {"width_mm": 2500.0, "depth_mm": 2000.0,
                     "wall_h_mm": 1500.0, "ridge_h_mm": 2200.0},
        "largest": {"width_mm": 3500.0, "depth_mm": 2500.0,
                    "wall_h_mm": 2000.0, "ridge_h_mm": 2800.0}},
}


def make_root(dest: str, *, pool: int = 3, scenes=None) -> str:
    """A checkout-like folder under ``dest`` holding the tiny benchmark
    (``scenes`` in place of :data:`SCENES`); returns its path."""
    root = os.path.join(dest, "tiny")
    bench = os.path.join(root, "benchmark")
    for sub in ("traffic", "metrics", "workloads"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub),
                        os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "configs"))
    man = load_manifest()
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["scene"] = dict(cfg["scene"], pool=pool,
                            **(scenes or SCENES)[c["name"]])
        cfg["pipeline"] = dict(cfg["pipeline"], knn_method="window")
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
