"""Whole runs at a tiny size on the CPU (the port's plain paths, no card):
each traffic kind and the reference against the port, the control and
the timed path's faults failing the comparison, and a cell that exists
only in a new folder.  No timing is read."""

import dataclasses
import json
import os
import shutil
import sys

import pytest
import torch

from benchmark.harness import loop
from benchmark.harness.check import judge
from benchmark.harness.manifest import load_cell, load_manifest, load_traffic
from benchmark.tests import tiny as tiny_bench

CELLS = [w["name"] for w in load_manifest()["workloads"]]
SEED = 5000000029
#: the sources of per-layer metrics that the port's timings and counters
#: give, which a CPU run reads as the card's does
PROGRAM = ("program_span", "program_counter")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, cell, trace=0):
    return tiny_bench.run(root, cell, SEED, trace=trace)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in load_cell(cell, tiny).end_to_end}
    # the CPU has no device memory to read
    assert set(res["metrics"]) == want - {"peak_mem_gib"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", [
    c for c in CELLS
    if any(m["source"] in PROGRAM for m in load_cell(c).per_layer)])
def test_traced_run_reads_per_layer_metrics(tiny, cell):
    res = _run(tiny, cell, trace=1)
    assert res["correct"], res["checks"]
    # on the CPU no device operation runs: the cell's per-layer metrics
    # from the program's timings and counters are there, and the idle
    # share of a trace with no device time; the rooflines are not
    names = set(res["metrics"])
    per_layer = load_cell(cell, tiny).per_layer
    want = {m["name"] for m in per_layer
            if m["source"] in PROGRAM or m["name"] == "device_idle_pct"}
    assert want <= names, sorted(want - names)
    assert not any(n.endswith("_roofline") for n in names)
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    return tiny_bench.make_root(
        str(tmp_path_factory.mktemp("bench_control")), pool=2,
        scene="control")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(control_root, cell, tmp_path):
    """The reference with TF32 products, in the program's place, fails
    the cell's limits (at the cell's spacing, on houses the CPU runs in
    seconds)."""
    c = load_cell(cell, control_root)
    traffic = load_traffic(c)
    ctx = loop.Ctx(seed=SEED + 1, seconds=6.0, trace=False,
                   device=torch.device("cpu"), tmpdir=str(tmp_path),
                   t_start=0.0, t_start_wall=0.0)
    record = traffic.run(c, ctx)
    ok, checks = judge(traffic.check(c, record, ctx), c.limits())
    assert ok  # the program itself passes
    ok, checks = judge(traffic.check(c, record, ctx, control=True),
                       c.limits())
    assert not ok, checks


def _alter_labels(orig):
    """The timed path's answer altered where it is produced: every label
    moved one row on."""
    def wrap(*a, **kw):
        shifted, lo, seg = orig(*a, **kw)
        return shifted, lo, dataclasses.replace(
            seg, plane_idx=torch.roll(seg.plane_idx, 1))
    return wrap


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(tiny, cell, monkeypatch):
    from buildingsegment_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "run_device_pipeline",
                        _alter_labels(pipeline.run_device_pipeline))
    res = _run(tiny, cell)
    assert not res["correct"]
    assert res["checks"]["label_mismatch"]["value"] > 0


def test_short_batch_is_not_correct(tiny, monkeypatch):
    """Half of the batch left out: the survey's call returns fewer scans
    than it was given."""
    from buildingsegment_tpu_torch import pipeline

    orig = pipeline.segment_files
    calls = []

    def half(ins, outs, *a, **kw):
        calls.append(1)
        if len(calls) <= 1:  # the warm-up's one batch (a pool of 3)
            return orig(ins, outs, *a, **kw)
        return orig(ins[:len(ins) // 2], outs[:len(outs) // 2], *a, **kw)
    monkeypatch.setattr(pipeline, "segment_files", half)
    cell = [c for c in CELLS if c.endswith(".survey_batch")][0]
    res = _run(tiny, cell)
    # every window step failed, and no output of a sampled scan came
    assert not res["correct"]
    assert res["failed"] > 0


def test_a_cell_in_a_new_folder_only(tiny, tmp_path):
    """A cell, a configuration, a traffic kind and a metric added as new
    files and new manifest entries, with no file edited."""
    root = str(tmp_path / "root")
    shutil.copytree(tiny, root)
    man = load_manifest(root)
    man["configs"].append(dict(man["configs"][0], name="tiny_house",
                               file="benchmark/configs/tiny_house.json"))
    with open(os.path.join(root, man["configs"][0]["file"])) as f:
        cfg = json.load(f)
    cfg["scene"]["pool"] = 2
    with open(os.path.join(root, "benchmark/configs/tiny_house.json"),
              "w") as f:
        json.dump(cfg, f)
    man["workloads"].append({"name": "tiny_house.twice", "config":
                             "tiny_house", "traffic": "twice", "chips": 1,
                             "why": "a cell added by files alone"})
    man["per_layer"].append({"name": "scans_done", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "mpts_per_s",
                             "workloads": ["tiny_house.twice"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    wl = json.load(open(os.path.join(
        root, "benchmark/workloads/tls_house_25mm.cli_loop.json")))
    wl.update(config="tiny_house", traffic="twice")
    with open(os.path.join(root, "benchmark/workloads/tiny_house.twice.json"),
              "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "benchmark/traffic/twice.py"), "w") as f:
        f.write("from benchmark.traffic.cli_loop import run, check\n")
    with open(os.path.join(root, "benchmark/metrics/scans_done.py"),
              "w") as f:
        f.write("def read(record):\n"
                "    return len(record['window']['rows'])\n")
    res = _run(root, "tiny_house.twice", trace=1)
    assert res["correct"], res["checks"]
    assert res["metrics"]["scans_done"]["value"] > 0
    sys.modules.pop("benchmark.traffic.twice", None)
