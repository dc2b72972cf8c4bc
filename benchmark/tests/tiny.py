"""A copy of the benchmark at a size the CPU runs in seconds: the same
manifest, cells, traffic kinds, kNN paths, metrics and limits, with each
configuration's scene made small and its pipeline set to the kNN path
it states (such small scans would resolve "auto" to brute).  Used by the
tests to drive whole runs on the port's plain paths.

Each configuration's small scenes are a file of their own,
``benchmark/tests/scenes/<config>.json``: ``tiny`` for the runs and
``control`` for the control's test, at which the control shows.  The
copy holds those files too, so a copy can serve as the source of
another."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.harness.manifest import ROOT, load_manifest

#: the folders under benchmark/ that a copy takes as they are
COPIED = ("traffic", "metrics", "workloads", "paths", "tests/scenes")
#: a window that finishes every scan of the tiny pool on a loaded CPU: a
#: sampled scan the window never reached fails the run, as on the card
WINDOW_S = 4.0


def scenes_file(root: str, config: str) -> str:
    return os.path.join(root, "benchmark", "tests", "scenes",
                        f"{config}.json")


def make_root(dest: str, *, pool: int = 3, scene: str = "tiny",
              src: str = ROOT) -> str:
    """A checkout-like folder under ``dest`` holding the benchmark of
    ``src`` with each configuration's ``scene`` (``tiny`` or ``control``)
    from its scenes file; returns its path."""
    root = os.path.join(dest, "tiny")
    bench = os.path.join(root, "benchmark")
    for sub in COPIED:
        shutil.copytree(os.path.join(src, "benchmark", sub),
                        os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    man = load_manifest(src)
    for c in man["configs"]:
        with open(os.path.join(src, c["file"])) as f:
            cfg = json.load(f)
        with open(scenes_file(src, c["name"])) as f:
            small = json.load(f)[scene]
        cfg["scene"] = dict(cfg["scene"], pool=pool, **small)
        if "knn_method" in cfg:
            cfg["pipeline"] = dict(cfg["pipeline"],
                                   knn_method=cfg["knn_method"])
        out = os.path.join(root, c["file"])
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def run(root: str, cell: str, seed: int, *, trace: int = 0,
        seconds: float = WINDOW_S) -> dict:
    """One run of ``cell`` of the benchmark under ``root`` on the CPU, on
    the port's plain paths; its result."""
    from benchmark import run as bench_run

    args = bench_run.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace",
                            str(trace)])
    return bench_run.run_cell(args, device="cpu", root=root)
