"""The manifest against the contract it is written to, and the files it
names.  Run: ``python -m pytest benchmark/tests -q``."""

import json
import os
import re

import pytest

from benchmark.harness.manifest import ROOT, load_cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
MAN = load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


def _line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"],
                                                         int)
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_names_only_files_under_paths():
    for word in MAN["command"][1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word == p or word.startswith(p + "/")
                       for p in MAN["paths"])


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_entry_keys_and_names(entry):
    assert NAME.match(entry["name"])
    if "file" in entry:  # a configuration
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert _line(entry["source"]) and _line(entry["why"])
        assert len(entry["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in entry["reduced"])
    elif "traffic" in entry:  # a cell
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4) and _line(entry["why"])
    else:  # a metric
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")
        if entry in MAN["end_to_end"]:
            assert set(entry) - {"workloads"} == {"name", "unit", "better",
                                                  "bound", "source"}
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0 < entry["bound"] <= 0.25
        else:
            assert set(entry) - {"workloads"} == {
                "name", "unit", "better", "source", "layer", "moves"}
            assert entry["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
            assert _line(entry["layer"])


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_quad_cells_at_most_a_quarter():
    quad = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert quad <= max(1, len(MAN["workloads"]) // 4)


def test_every_config_used_and_setup_bounded():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    c = load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # each per-layer metric moves an end-to-end metric its cells report
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_files_the_manifest_names_exist(cell):
    c = load_cell(cell)
    bench = os.path.join(ROOT, "benchmark")
    assert os.path.exists(os.path.join(bench, "traffic", f"{c.traffic}.py"))
    for m in c.end_to_end + c.per_layer:
        assert os.path.exists(os.path.join(bench, "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert os.path.exists(os.path.join(bench, "roofline",
                                               f"{kernel}.py"))
    entry = {e["name"]: e for e in MAN["configs"]}[c.config["name"]]
    assert entry["file"].startswith("benchmark/")
    assert set(entry["reduced"]) == set(c.config["reduced"])
    assert c.config["chips"] == {w["name"]: w for w in
                                 MAN["workloads"]}[cell]["chips"]
    # every number the cell compares has its limit
    assert c.limits() and all(v >= 0 for v in c.limits().values())


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_every_config_states_a_path_with_its_files(entry):
    """The kNN path the configuration states has its module, and the
    configuration its tiny scenes for the CPU tests."""
    with open(os.path.join(ROOT, entry["file"])) as f:
        method = json.load(f).get("knn_method")
    assert method and NAME.match(method)
    bench = os.path.join(ROOT, "benchmark")
    assert os.path.isfile(os.path.join(bench, "paths", f"{method}.py"))
    with open(os.path.join(bench, "tests", "scenes",
                           f"{entry['name']}.json")) as f:
        assert {"tiny", "control"} <= set(json.load(f))


def test_per_layer_workloads_are_cells():
    for m in METRICS:
        for w in m.get("workloads", []):
            assert w in CELLS


def test_workload_files_match_the_manifest():
    for w in MAN["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{w['name']}.json")) as f:
            wl = json.load(f)
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
