"""The kNN path modules (``benchmark/paths/<knn_method>.py``) and the
tiny scenes files (``benchmark/tests/scenes/<config>.json``), on the
CPU: the window path's module gives what the window functions give, a
configuration whose path has no file stops in set-up, and a
configuration enters a copy of the tiny benchmark by new files and
manifest entries alone, its stage 1 taken by the path module the copy
holds."""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest

from benchmark.harness import loop
from benchmark.harness.check import compare_stage1
from benchmark.harness.manifest import load_cell, load_manifest
from benchmark.harness.paths import load_path
from benchmark.harness.refcheck import padded_count
from benchmark.harness.scenes import make_pool
from benchmark.harness.wraps import capture_stage1
from benchmark.reference.io import read_input_mm
from benchmark.reference.segment import segment_reference
from benchmark.tests import tiny as tiny_bench

SEED = 5000000041
CELLS = [w["name"] for w in load_manifest()["workloads"]]
CLI = [c for c in CELLS if c.endswith(".cli_loop")][0]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench.make_root(str(tmp_path_factory.mktemp("paths")),
                                pool=2)


def _copy(tiny, dest) -> str:
    root = str(dest)
    shutil.copytree(tiny, root)
    return root


def _same(a: dict, b: dict, where=""):
    """Bit for bit, key by key."""
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k], f"{where}.{k}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), f"{where}.{k}"
        assert x.tobytes() == y.tobytes(), f"{where}.{k}"


def test_window_module_gives_what_the_window_functions_give(tiny, tmp_path):
    """Stage 1 captured, the reference (and its control) and stage 1's
    numbers of one tiny scan, through ``paths/window.py`` and through
    the functions the traffic kinds called before."""
    from buildingsegment_tpu_torch import pipeline
    from buildingsegment_tpu_torch.config import PipelineConfig

    cell = load_cell(CLI, tiny)
    path = load_path(cell)
    assert path.__file__ == os.path.join(tiny, "benchmark", "paths",
                                         "window.py")
    params = cell.config["pipeline"]
    src = loop.write_pool(make_pool(cell.config["scene"], SEED)[:1],
                          str(tmp_path))[0]
    by_path, by_window = [], []
    with path.capture(by_path), capture_stage1(by_window):
        pipeline.segment_file(src, os.devnull, PipelineConfig(**params),
                              device="cpu")
    assert len(by_path) == len(by_window) == 1
    _same(by_path[0], by_window[0], "capture")

    mm = read_input_mm(src)
    cap = padded_count(len(mm), params["pad_to_multiple"])
    for tf32 in (True, False):
        ref = path.reference(mm, params, capacity=cap, device="cpu",
                             tf32=tf32)
        ref_w = segment_reference(mm, params, capacity=cap, device="cpu",
                                  tf32=tf32)
        _same(dataclasses.asdict(ref), dataclasses.asdict(ref_w),
              f"reference tf32={tf32}")
    nums = path.compare_stage1(by_path[0], ref.stage1, len(mm))
    assert nums == compare_stage1(by_window[0], ref_w.stage1, len(mm))
    assert {"sort_mismatch", "normal_gap_determined",
            "curvature_gap"} <= nums.keys()


@pytest.mark.parametrize("method", ["pallas", None])
@pytest.mark.parametrize("cell", CELLS)
def test_a_path_with_no_file_stops_in_setup(tiny, tmp_path, monkeypatch,
                                            cell, method):
    """A configuration stating a path that has no file (or stating
    none) stops the run before its pool is written or a window runs,
    and the message names the file the loader looked for."""
    root = _copy(tiny, tmp_path / "root")
    entry = load_manifest(root)["configs"][0]
    cfg_file = os.path.join(root, entry["file"])
    with open(cfg_file) as f:
        cfg = json.load(f)
    cfg.pop("knn_method")
    if method is not None:
        cfg["knn_method"] = method
    with open(cfg_file, "w") as f:
        json.dump(cfg, f)
    calls = []
    for name in ("write_pool", "closed_loop"):
        monkeypatch.setattr(loop, name,
                            lambda *a, name=name, **kw: calls.append(name))
    with pytest.raises(SystemExit) as stop:
        tiny_bench.run(root, cell, SEED)
    want = os.path.join(root, "benchmark", "paths",
                        f"{method or '<knn_method>'}.py")
    assert want in str(stop.value.code)
    assert calls == []


def test_a_missing_scenes_file_is_named(tiny, tmp_path):
    src = _copy(tiny, tmp_path / "src")
    config = load_manifest(src)["configs"][0]["name"]
    os.remove(tiny_bench.scenes_file(src, config))
    with pytest.raises(FileNotFoundError,
                       match=f"scenes/{config}.json"):
        tiny_bench.make_root(str(tmp_path / "made"), src=src)


def _add(root: str, rel: str, obj: dict) -> None:
    """A new file (mode "x": an existing file is never edited)."""
    with open(os.path.join(root, rel), "x") as f:
        json.dump(obj, f)


def test_a_config_enters_by_new_files_alone(tiny, tmp_path):
    """A second window configuration in a copy of the tiny benchmark: its
    configuration, scenes and workload files and its manifest entries,
    no file edited.  ``make_root`` takes the copy as its source, and the
    new cell runs on the path it states and reads correct."""
    src = _copy(tiny, tmp_path / "src")
    man = load_manifest(src)
    base = man["configs"][0]
    name = "tls_house_25mm_second"
    with open(os.path.join(src, base["file"])) as f:
        cfg = json.load(f)
    _add(src, f"benchmark/configs/{name}.json", cfg)
    with open(tiny_bench.scenes_file(src, base["name"])) as f:
        scenes = json.load(f)
    scenes["tiny"]["largest"]["width_mm"] = 2800.0
    _add(src, f"benchmark/tests/scenes/{name}.json", scenes)
    base_cell = [w for w in man["workloads"] if w["config"] == base["name"]
                 and w["traffic"] == "cli_loop"][0]
    with open(os.path.join(src, "benchmark", "workloads",
                           f"{base_cell['name']}.json")) as f:
        wl = json.load(f)
    cell = f"{name}.cli_loop"
    _add(src, f"benchmark/workloads/{cell}.json", dict(wl, config=name))
    man["configs"].append(dict(base, name=name,
                               file=f"benchmark/configs/{name}.json"))
    man["workloads"].append(dict(base_cell, name=cell, config=name))
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)

    root = tiny_bench.make_root(str(tmp_path / "made"), pool=2, src=src)
    made = load_cell(cell, root).config
    assert made["pipeline"]["knn_method"] == made["knn_method"] == "window"
    assert made["scene"]["largest"]["width_mm"] == 2800.0
    res = tiny_bench.run(root, cell, SEED)
    assert res["correct"], res["checks"]


WRAPPER = '''"""The window path, recording its calls and delegating."""
import contextlib

from benchmark.harness.check import compare_stage1 as _compare
from benchmark.harness.wraps import capture_stage1 as _capture
from benchmark.reference.segment import segment_reference as _reference

CALLS = []


@contextlib.contextmanager
def capture(into):
    CALLS.append("capture")
    with _capture(into):
        yield into


def reference(*a, **kw):
    CALLS.append("reference")
    return _reference(*a, **kw)


def compare_stage1(*a, **kw):
    CALLS.append("compare_stage1")
    return _compare(*a, **kw)
'''


@pytest.mark.parametrize("cell", CELLS)
def test_the_copys_path_file_is_the_one_the_run_uses(tiny, tmp_path, cell):
    root = _copy(tiny, tmp_path / "root")
    path = os.path.join(root, "benchmark", "paths", "window.py")
    with open(path, "w") as f:
        f.write(WRAPPER)
    try:
        res = tiny_bench.run(root, cell, SEED)
        mod = sys.modules["benchmark.paths.window"]
        assert mod.__file__ == path
        # a pool of 2: both scans sampled, each one reference and one
        # comparison of stage 1, captured once a warm-up call
        assert mod.CALLS.count("reference") == 2
        assert mod.CALLS.count("compare_stage1") == 2
        assert mod.CALLS.count("capture") >= 1
        assert res["correct"], res["checks"]
    finally:
        sys.modules.pop("benchmark.paths.window", None)
