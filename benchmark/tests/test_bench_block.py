"""The block configuration (``configs/tls_block_25mm.json``) and its
traffic on the CPU: the pool's seed law at the cell's own sizes, the
path every pool scan takes, and a tiny run of the cell against the plain
reference, whose traced run reads the block's counters.  Run: ``python
-m pytest benchmark/tests/test_bench_block.py -q``."""

import json
import os

import numpy as np
import pytest

from benchmark.harness.blocks import block_jobs, make_block_pool
from benchmark.harness.manifest import ROOT, load_cell, metric_reader
from benchmark.harness.scenes import DIMS
from benchmark.tests import tiny as tiny_bench
from benchmark.traffic.cli_loop import _port, check_paths

CELL = "tls_block_25mm.block_cli_loop"
SEEDS = (5000000087, 2 ** 31 + 11)
NEW_METRICS = ("sweeps_per_scan.block", "finalize_ms.block",
               "finalize_rows_per_scan.block")


@pytest.fixture(scope="module")
def cell():
    return load_cell(CELL)


@pytest.fixture(scope="module")
def counts(cell):
    """Each seed's pool sizes at the cell's own scene (the scans are
    dropped once counted)."""
    return {s: [len(p) for p in make_block_pool(cell.config["scene"], s)]
            for s in SEEDS}


def test_pool_sizes_and_seed_law(cell, counts):
    scene = cell.config["scene"]
    assert [g[0] * g[1] for g in scene["grids"]] == [6, 8, 9, 10, 12, 12]
    a, b = (np.asarray(counts[s], float) for s in SEEDS)
    assert len(a) == scene["pool"] == 6
    # 3.0M-6.1M points a scan, the smallest block first
    assert 2.9e6 < a.min() == a[0] and a.max() < 6.2e6
    # each dimension moves by at most 1%: each block's count by under 2%
    assert np.all(np.abs(a / b - 1.0) < 0.02)
    for s in SEEDS:
        for job in block_jobs(scene, s):
            houses = job["houses"]
            assert len(houses) == job["nx"] * job["ny"]
            for lo_hi, house in ((scene["smallest"], houses[0]),
                                 (scene["largest"], houses[-1])):
                for d in DIMS:
                    assert abs(house[d] / lo_hi[d] - 1.0) <= 0.01 + 1e-12


def test_every_pool_scan_takes_the_window_path(cell, counts):
    pipeline, config = _port(cell)
    for s in SEEDS:
        # check_paths reads each scan's length alone
        stand_ins = [np.empty((n, 0), np.int8) for n in counts[s]]
        check_paths(cell, pipeline, config, stand_ins, config.padded_count)


def test_same_seed_same_scans():
    with open(tiny_bench.scenes_file(ROOT, "tls_block_25mm")) as f:
        small = json.load(f)["tiny"]
    with open(os.path.join(ROOT, "benchmark/configs/tls_block_25mm.json")) as f:
        scene = dict(json.load(f)["scene"], pool=3, **small)
    one, two = make_block_pool(scene, SEEDS[0]), make_block_pool(scene,
                                                                 SEEDS[0])
    other = make_block_pool(scene, SEEDS[1])
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    assert not any(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(one, other))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench.make_root(str(tmp_path_factory.mktemp("block")))


def test_tiny_blocks_agree_and_read_the_counters(tiny):
    # a window long enough that a loaded CPU reaches the sampled scans
    res = tiny_bench.run(tiny, CELL, SEEDS[0], trace=1, seconds=12.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["label_mismatch"]["value"] == 0.0
    for name in NEW_METRICS:
        assert res["metrics"][name]["value"] > 0, name


def test_counters_absent_read_nothing():
    """Rows of an older program, whose diagnostics lack the finalize's
    counters, give no reading, and raise nothing."""
    record = {"window": {"rows": [{"num_sweeps": 5, "diagnostics": {}},
                                  {"num_sweeps": 7}]}}
    assert metric_reader("finalize_rows_per_scan.block")(record) is None
    assert metric_reader("finalize_ms.block")(record) is None
    assert metric_reader("sweeps_per_scan.block")(record) == 6.0
