"""The exact-kNN path's module (``benchmark/paths/pallas.py``) and the work
counts of #14 and row S (``roofline/knn_exact.py``,
``roofline/segment_sums.py``), on the CPU: the exact cell loads its
path's module, the module's capture and comparison read a tiny scan's
stage 1 as the reference's (and the control apart), and each count
against the same count taken pair by pair or row by row."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import loop
from benchmark.harness.manifest import load_cell
from benchmark.harness.paths import load_path
from benchmark.harness.refcheck import padded_count
from benchmark.harness.scenes import make_pool
from benchmark.reference.io import read_input_mm
from benchmark.roofline import knn_exact, segment_sums
from benchmark.tests import tiny as tiny_bench

SEED = 5000000059
CELL = "tls_house_25mm_exact.cli_loop"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench.make_root(str(tmp_path_factory.mktemp("exact")),
                                pool=2)


def test_the_exact_cell_loads_its_path_and_compares_stage1(tiny, tmp_path):
    from buildingsegment_tpu_torch import pipeline
    from buildingsegment_tpu_torch.config import PipelineConfig

    cell = load_cell(CELL, tiny)
    path = load_path(cell)
    assert path.__file__ == os.path.join(tiny, "benchmark", "paths",
                                         "pallas.py")
    params = cell.config["pipeline"]
    assert params["knn_method"] == cell.config["knn_method"] == "pallas"
    src = loop.write_pool(make_pool(cell.config["scene"], SEED)[-1:],
                          str(tmp_path))[0]
    got = []
    with path.capture(got):
        pipeline.segment_file(src, os.devnull, PipelineConfig(**params),
                              device="cpu")
    assert len(got) == 1 and got[0]["knn_calls"] == 1
    assert {"knn_tiles_listed",
            "knn_query_tiles"} <= got[0]["diagnostics"].keys()
    mm = read_input_mm(src)
    n = len(mm)
    cap = padded_count(n, params["pad_to_multiple"])
    ref = path.reference(mm, params, capacity=cap, device="cpu")
    nums = path.compare_stage1(got[0], ref.stage1, n)
    assert nums["neighbour_mismatch"] == nums["kth_dist_gap"] == 0.0
    assert nums["normal_gap_determined"] < 1e-6
    # one list moved by one slot; lists from more than one knn_pallas call
    bad = dict(got[0], neigh_idx=got[0]["neigh_idx"].copy())
    bad["neigh_idx"][3, 1:] = np.roll(bad["neigh_idx"][3, 1:], 1)
    moved = path.compare_stage1(bad, ref.stage1, n)
    assert moved["neighbour_mismatch"] == pytest.approx(1 / n)
    bad["knn_calls"] = 2
    assert path.compare_stage1(bad, ref.stage1, n)["neighbour_mismatch"] == 1
    # the control: the same lists, other moments
    ctl = path.reference(mm, params, capacity=cap, device="cpu", tf32=True)
    ctl_nums = path.compare_stage1(ctl.stage1, ref.stage1, n)
    assert ctl_nums["neighbour_mismatch"] == 0.0
    assert ctl_nums["curvature_gap"] > nums["curvature_gap"]


def _tiles_by_definition(p, valid, last_d, qt, ct):
    """Pairs to test, query tile by candidate tile, from the definition."""
    n = len(p)
    pairs = 0
    for q0 in range(0, n, qt):
        qv = valid[q0:q0 + qt]
        if not qv.any():
            continue
        qp = p[q0:q0 + qt][qv]
        tau = last_d[q0:q0 + qt][qv].max()
        for c0 in range(0, n, ct):
            cv = valid[c0:c0 + ct]
            if not cv.any():
                continue
            cp = p[c0:c0 + ct][cv]
            gap = np.maximum(np.maximum(cp.min(0) - qp.max(0),
                                        qp.min(0) - cp.max(0)), 0.0)
            if (gap ** 2).sum() <= tau:
                pairs += len(qp) * len(cp)
    return pairs


def test_knn_exact_count():
    """The pairs a 128 × 1,024 tiling tests under each query tile's final
    k-th distance, against a walk over every pair of tiles; bytes are the
    positions in and the lists out."""
    from buildingsegment_tpu_torch.ops import pallas_knn

    rng = np.random.default_rng(3)
    n, k = 4096, 16
    pts = rng.integers(0, 3000, (n, 3)).astype(np.int32)
    mask = torch.ones(n, dtype=torch.bool)
    mask[-300:] = False
    (cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct,
     w) = pallas_knn._prepare(torch.from_numpy(pts), mask, k)
    args = (cols, seed_d, seed_i, visit, visit_d2, counts)
    kw = dict(qt=qt, ct=ct, w_excl=w)
    out = pallas_knn.knn_exact_reference(*args, **kw)
    nbytes, ops = knn_exact.work(args, kw, out)
    p = torch.stack(cols, 1).double().numpy()
    valid = mask.numpy()
    want = _tiles_by_definition(p, valid, out[0][:, -1].double().numpy(),
                                qt, ct)
    assert ops == 9 * want
    assert (n - 300) * (k - 1) < want <= (n - 300) ** 2
    assert nbytes == 3 * 4 * n + n * (k - 1) * 8


def test_segment_sums_count():
    idx = torch.tensor([0, 2, 2, 5, 1], dtype=torch.int64)
    rows = torch.ones((5, 3))
    out = torch.zeros((6, 3))
    assert segment_sums.work((idx, rows, 6), {}, out) == (
        5 * 8 + 5 * 3 * 4 + 6 * 3 * 4, 15)
    init = torch.zeros((6, 3))
    assert segment_sums.work((idx, rows, 6, init), {}, out)[0] == (
        5 * 8 + 5 * 3 * 4 + 2 * 6 * 3 * 4)


def test_scenes_file_keeps_the_cells_spacing_for_the_control():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(root, "benchmark", "tests", "scenes",
                           "tls_house_25mm_exact.json")) as f:
        scenes = json.load(f)
    with open(os.path.join(root, "benchmark", "configs",
                           "tls_house_25mm_exact.json")) as f:
        cfg = json.load(f)
    assert scenes["control"]["spacing_mm"] == cfg["scene"]["spacing_mm"]
