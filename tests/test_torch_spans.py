"""The port's spans (``profiling.annotate``) on the CPU.

A span adds its wall time to its timings key with the profiler on and
off, and enters a ``record_function`` range only while a profiler runs;
the flag it reads follows every profiler setting on every thread.  A
``profiling.trace`` of ``segment_file`` holds a span at each host stage
and one ``seg.sync`` a device → host read the solve counts; a trace of
``segment_files`` (and of the CLI's ``--batch``) holds the reader's and
the writer's spans on their own threads, the main thread's waits and
its fetches, and no device stage on the writer's.
Children stay inside their parents, and the solve takes no
synchronize of its own.
"""

import collections
import contextlib
import json
import os
import threading

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from buildingsegment_tpu_torch import pipeline
from buildingsegment_tpu_torch.cli import main
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud, write_ply
from buildingsegment_tpu_torch.pipeline import segment_file, segment_files
from buildingsegment_tpu_torch.profiling import TRACE_FILE, annotate, trace
from buildingsegment_tpu_torch.utils import make_building_cloud

# the multigrid window path at a normal radius that suits 250 mm spacing
_CFG = PipelineConfig(knn_method="window", normal_radius=400.0)
_UPLOAD = ("upload.shift", "upload.copy", "upload.hints", "upload.sync")
_CLI_SPANS = {"read_ply", "host_to_device", *_UPLOAD, "stage1",
              "segmentation", "device_to_host", "colorize", "write_ply",
              "seg.seed", "seg.sweep", "seg.sync", "seg.finish"}
_PATH_SPANS = {
    "window": {"stage1.cells", "unsort", "mg.seed", "mg.refine",
               "mg.finalize"},
    "brute": {"knn", "normals"},
}


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    d = tmp_path_factory.mktemp("scans")
    paths = []
    for seed in (1, 2):
        pts, _ = make_building_cloud(seed=seed, spacing_mm=250.0,
                                     noise_mm=10.0)
        path = str(d / f"scan{seed}.ply")
        write_ply(HostPointCloud(positions=pts), path, position_scale=0.001)
        paths.append(path)
    return paths


def _events(log_dir):
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if str(e.get("cat", "")).lower() == "user_annotation"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("profiled", [False, True])
def test_annotate_accumulates(profiled):
    timings = {"other": 1.0}
    with (_cpu_profile() if profiled else contextlib.nullcontext()):
        for _ in range(3):
            with annotate("stage", timings):
                pass
        with annotate("stage"):  # no dict: nothing is recorded
            pass
    assert set(timings) == {"other", "stage"} and timings["other"] == 1.0
    assert 0.0 < timings["stage"] < 1.0


def test_annotate_enters_a_range_only_under_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timings = {}
    with annotate("off", timings):
        pass
    assert entered == [] and "off" in timings
    with _cpu_profile() as prof:
        with annotate("on", timings):
            pass
    assert entered == ["on"] and "on" in timings
    assert "on" in {e.name for e in prof.events()}


@pytest.mark.parametrize("all_threads", [False, True])
def test_profiler_flag_follows_every_profiler(all_threads, tmp_path):
    """``annotate`` tests ``torch.autograd.profiler._is_profiler_enabled``:
    it must be true, on the main thread and on a worker, under both the
    default profiler and ``profiling.trace``'s all-threads profiler, and
    false outside them (else an upgrade of torch silently drops every
    span from traces, or costs a range on every span)."""
    seen = {}

    def probe():
        seen["worker"] = autograd_profiler._is_profiler_enabled

    assert autograd_profiler._is_profiler_enabled is False
    cm = trace(str(tmp_path), device="cpu") if all_threads else _cpu_profile()
    with cm:
        seen["main"] = autograd_profiler._is_profiler_enabled
        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == {"main": True, "worker": True}
    assert autograd_profiler._is_profiler_enabled is False


@pytest.mark.parametrize("method", ["window", "brute"])
def test_segment_file_trace_holds_the_stage_spans(scans, tmp_path, method):
    cfg = PipelineConfig(knn_method=method, normal_radius=400.0)
    with trace(str(tmp_path / "t"), device="cpu"):
        out = segment_file(scans[0], str(tmp_path / "o.ply"), cfg,
                           device="cpu")
    names = {e["name"] for e in _events(tmp_path / "t")}
    want = _CLI_SPANS | _PATH_SPANS[method]
    assert want <= names, want - names
    # a span's name is its timings key
    assert want <= set(out.timings), want - set(out.timings)


@pytest.mark.parametrize("compact", [False, True])
def test_one_sync_span_a_host_read(scans, tmp_path, compact):
    cfg = PipelineConfig(knn_method="window", normal_radius=400.0,
                         seg_compact=compact)
    with trace(str(tmp_path / "t"), device="cpu"):
        out = segment_file(scans[1], str(tmp_path / "o.ply"), cfg,
                           device="cpu")
    names = collections.Counter(e["name"] for e in _events(tmp_path / "t"))
    assert out.host_syncs > 0
    assert names["seg.sync"] == out.host_syncs
    assert names["seg.sweep"] == out.num_sweeps


@pytest.mark.parametrize("method", ["window", "brute"])
def test_children_inside_parents(scans, tmp_path, method):
    cfg = PipelineConfig(knn_method=method, normal_radius=400.0)
    t = segment_file(scans[0], str(tmp_path / "o.ply"), cfg,
                     device="cpu").timings
    assert sum(t[k] for k in _UPLOAD) <= t["host_to_device"]
    assert t["seg.sync"] <= t["segmentation"]
    assert (t["seg.seed"] + t["seg.sweep"] + t["seg.finish"]
            <= t["segmentation"])
    if method == "brute":
        assert t["knn"] + t["normals"] <= t["stage1"]


def test_segment_files_spans_by_thread(scans, tmp_path):
    with trace(str(tmp_path / "t"), device="cpu"):
        segment_files(scans, [str(tmp_path / f"o{i}.ply") for i in (0, 1)],
                      _CFG, device="cpu", render_dir=str(tmp_path / "r"))
    by_tid = collections.defaultdict(set)
    for e in _events(tmp_path / "t"):
        by_tid[e["tid"]].add(e["name"])
    main_tid = threading.get_native_id()
    main_spans = by_tid.pop(main_tid)
    assert {"wait.reader", "wait.writer", "stage1", "stage1.cells",
            "segmentation", "unsort", "seg.sync", "render.dispatch",
            "device_to_host", "render.finish"} <= main_spans
    assert not main_spans & {"reader.load_scan", "read_ply", "write_ply",
                             "colorize"}
    reader = [s for s in by_tid.values() if "reader.load_scan" in s]
    writer = [s for s in by_tid.values() if "write_ply" in s]
    assert len(reader) == 1 and len(writer) == 1
    assert {"read_ply", "dedup", *_UPLOAD} <= reader[0]
    # the writer's work is on the host: the colours, the PLY, the PNGs
    assert {"colorize", "write_ply", "render.finish"} <= writer[0]
    assert not writer[0] & {"render.dispatch", "device_to_host", "stage1",
                            "segmentation"}


def test_segment_files_timings(scans, tmp_path):
    outs = segment_files(scans, [str(tmp_path / f"o{i}.ply") for i in (0, 1)],
                         _CFG, device="cpu", render_dir=str(tmp_path / "r"))
    for out in outs:
        t = out.timings
        assert t["host_to_device"] == t["reader.load_scan"]
        assert t["host_to_device"] >= t["read_ply"] + t["dedup"] + sum(
            t[k] for k in _UPLOAD)
        assert t["render"] == t["render.dispatch"] + t["render.finish"]
        assert {"wait.reader", "wait.writer", "write_ply", "segmentation",
                "seg.sync"} <= set(t)


def test_solve_takes_no_synchronize(scans, tmp_path, monkeypatch):
    """The window path synchronizes four times a scan — the upload's end,
    stage 1's, the solve's and the unsort's — and the solve's modules
    none of their own."""
    from buildingsegment_tpu_torch.seg import coarse, region_grow

    assert not hasattr(coarse, "synchronize")
    assert not hasattr(region_grow, "synchronize")
    calls = []
    monkeypatch.setattr(pipeline, "synchronize",
                        lambda dev: calls.append(dev))
    segment_file(scans[0], str(tmp_path / "o.ply"), _CFG, device="cpu")
    assert len(calls) == 4


def test_cli_batch_trace(scans, tmp_path, capsys):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for p in scans:
        os.symlink(p, in_dir / os.path.basename(p))
    rc = main(["--batch", str(in_dir), str(tmp_path / "out"), "--trace",
               str(tmp_path / "t"), "--normal-radius", "400",
               "--knn-method", "window"], device="cpu")
    assert rc == 0
    names = {e["name"] for e in _events(tmp_path / "t")}
    assert {"reader.load_scan", "wait.reader", "write_ply",
            "segmentation"} <= names
