"""The metric arithmetic on synthetic records, the reading of a trace,
and the roofline counts from call inputs alone."""

import importlib

import pytest
import torch

from benchmark.harness.arith import (
    Coverage,
    covered,
    gaps,
    nearest_rank,
    rate_per_s,
    union,
)
from benchmark.harness.manifest import metric_reader
from benchmark.harness.trace import summarize
from benchmark.roofline.peaks import F32_OPS_PER_S, HBM_BYTES_PER_S


def _record(rows, start=0.0):
    return {"window": {"start": start, "rows": rows}}


def test_rate_is_over_the_whole_window():
    # three scans of 1M points; the window opened at 10 s and the last
    # scan ended at 13 s: 3 Mpts over 3 s, not over the scans' own time
    rows = [{"points": 1_000_000, "end": e, "latency_s": 0.5}
            for e in (11.0, 12.0, 13.0)]
    assert metric_reader("mpts_per_s")(_record(rows, 10.0)) == 1.0
    assert rate_per_s([], 0.0, []) is None


def test_p90_is_over_all_scans():
    rows = [{"latency_s": v / 1000, "points": 1, "end": 1.0}
            for v in range(1, 101)]
    assert metric_reader("scan_ms_p90")(_record(rows)) == pytest.approx(90.0)
    assert nearest_rank([5.0], 0.9) == 5.0
    assert nearest_rank(list(range(1, 11)), 0.9) == 9


def test_idle_share_is_a_union_of_overlapping_intervals():
    iv = [(0, 4), (2, 6), (5, 7), (10, 12)]
    assert union(iv) == [(0, 7), (10, 12)]
    assert covered(iv, 0, 20) == 9
    assert gaps(iv, 0, 20) == [(7, 10), (12, 20)]
    cov = Coverage(iv)
    for lo, hi in ((0, 20), (3, 11), (6.5, 10.5), (8, 9), (-5, 1)):
        assert cov(lo, hi) == pytest.approx(covered(iv, lo, hi))


def _ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
            "args": args}


def test_trace_summary():
    events = [
        _ev("user_annotation", "bench.traced", 0, 100),
        _ev("user_annotation", "segmentation", 40, 50),
        # two streams overlapping: busy is their union, 10..30 and 50..60
        _ev("kernel", "k_a", 10, 15, device=0, correlation=1),
        _ev("kernel", "k_b", 20, 10, device=0, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 50, 10, device=0, correlation=3),
        _ev("kernel", "other_card", 0, 100, device=1, correlation=4),
        _ev("user_annotation", "bench.kernel.stats_sweep", 8, 4),
        _ev("gpu_user_annotation", "bench.kernel.stats_sweep", 10, 15),
    ]
    s = summarize(events, 0)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    idle = dict(s["idle_gaps"])
    # gap 0..10 lies outside every port span; 30..50 (midpoint 40) and
    # 60..100 (midpoint 80) inside "segmentation"
    assert idle["segmentation"] == pytest.approx(60e-6)
    assert idle["host, no span"] == pytest.approx(10e-6)
    assert dict(s["device_ops"])["k_a"] == pytest.approx(15e-6)
    assert s["kernel_device_s"]["stats_sweep"] == [pytest.approx(15e-6)]
    # without device spans: by the launches' correlation ids
    events = [e for e in events if e["cat"] != "gpu_user_annotation"]
    events.append(_ev("cuda_runtime", "cudaLaunchKernel", 9, 1,
                      correlation=1))
    s = summarize(events, 0)
    assert s["kernel_device_s"]["stats_sweep"] == [pytest.approx(15e-6)]


def test_idle_pct_reader():
    read = metric_reader("device_idle_pct")
    assert read({"profile": {"busy_s": 1.0, "window_s": 4.0}}) == 75.0
    assert read({}) is None


def test_stats_sweep_work_from_inputs():
    work = importlib.import_module("benchmark.roofline.stats_sweep").work
    n, w = 8, 2
    mask = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    pos = tuple(torch.zeros(n) for _ in range(3))
    counts = mask.float() + 3.0  # three neighbours used a valid row
    out = (torch.zeros(n), counts, torch.zeros(n, 3), torch.zeros(n, 6))
    moved, ops = work((pos, mask), dict(k=15, w=w, radius=100.0,
                                        max_nn=50), out)
    # every input byte once (3·8·4 + 8) and every output byte once
    # (11·8·4)
    assert moved == 3 * n * 4 + n + 11 * n * 4
    # valid ordered pairs within ±2 of 7 valid rows of 8 (row 3 invalid)
    m = mask.tolist()
    pairs = sum(m[i] and m[j] for i in range(n) for j in range(n)
                if i != j and abs(i - j) <= w)
    # per pair d² (8), the radius test (1) and one statistic (k > 1;
    # max_nn − 1 = 49 ≥ 2w: no cap); per neighbour used the moments (19)
    assert ops == pairs * (8 + 1 + 1) + float(counts.sum() - mask.sum()) * 19


def test_roofline_reader():
    read = metric_reader("stats_sweep_roofline")
    # one call: 3.35 GB → 1 ms at the bandwidth, measured 4 ms → 25 %
    rec = {"profile": {"kernel_device_s": {"stats_sweep": [4e-3]}},
           "kernel_work": {"stats_sweep": [(HBM_BYTES_PER_S * 1e-3, 1.0)]}}
    assert read(rec) == pytest.approx(25.0)
    rec["kernel_work"]["stats_sweep"] = [(0, F32_OPS_PER_S * 2e-3)]
    assert read(rec) == pytest.approx(50.0)
    # the traced and counted runs disagree: nothing to read
    rec["kernel_work"]["stats_sweep"] *= 2
    assert read(rec) is None
