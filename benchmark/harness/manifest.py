"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells and the metrics.  Everything that belongs to one of them lives
in a file of its own, found by name under ``benchmark/``:

* ``configs/<config>.json`` (the ``file`` of its entry): the scene, the
  pipeline fields, the guarantees;
* ``workloads/<cell>.json``: the cell's configuration, traffic kind,
  traffic parameters and the limits of its comparison;
* ``traffic/<kind>.py``: a loop over one entry of the port, with
  ``run(cell, ctx) -> record``;
* ``paths/<knn_method>.py``: stage 1's capture, plain reference and
  comparison for the kNN path the configuration states
  (:mod:`benchmark.harness.paths`);
* ``metrics/<metric>.py``: ``read(record) -> float | None``.

So a later change adds a cell, a configuration (on any kNN path), a
traffic kind or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional

#: the root of the checkout: the folder that holds BENCHMARK.json and
#: benchmark/
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANIFEST = "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    root: str
    chips: int
    config: dict                 # the configuration file, plus "name"
    traffic: str                 # the traffic kind
    workload: dict               # workloads/<cell>.json
    end_to_end: List[dict]       # the manifest's metrics this cell reports
    per_layer: List[dict]

    def params(self) -> dict:
        return self.workload.get("params", {})

    def limits(self) -> dict:
        return self.workload["limits"]


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, MANIFEST)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the manifest under ``root``."""
    man = load_manifest(root)
    entry = {w["name"]: w for w in man["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {MANIFEST}")
    cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    config["name"] = cfg_entry["name"]
    with open(os.path.join(bench_dir(root), "workloads",
                           f"{name}.json")) as f:
        workload = json.load(f)
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} "
                             f"{workload[key]!r}, manifest {entry[key]!r}")
    return Cell(
        name=name, root=root, chips=entry["chips"], config=config,
        traffic=entry["traffic"], workload=workload,
        end_to_end=[m for m in man["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in man["per_layer"] if _reports(m, name)],
    )


def load_file(path: str, module: str):
    """The module in the file ``path``, importable by the name ``module``
    (loaded again where that name holds another file)."""
    have = sys.modules.get(module)
    if have is not None and getattr(have, "__file__", None) == path:
        return have
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


def load_traffic(cell: Cell):
    """The traffic kind's module (``traffic/<kind>.py``), importable by
    the name ``benchmark.traffic.<kind>`` (ranks of a spawned group import
    it by that name)."""
    path = os.path.join(bench_dir(cell.root), "traffic", f"{cell.traffic}.py")
    return load_file(path, f"benchmark.traffic.{cell.traffic}")


def metric_reader(name: str, root: str = ROOT) -> Callable[[dict],
                                                           Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir(root), "metrics", f"{name}.py")
    mod = load_file(path, "benchmark_metric_" + name.replace(".", "_"))
    return mod.read


def read_metrics(metrics: List[dict], record: dict,
                 root: str = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read in ``record``."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
