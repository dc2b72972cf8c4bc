"""The exact-kNN path (``knn_method="pallas"``) against the benchmark's
float64 exact reference (``benchmark/reference/exact_stage1.py``), on
the CPU: the reference's grid search against a brute force by
definition; the port's #14 lists (its plain version) equal to the
reference's bit for bit, indices and squared distances; the port's
determined normals and curvature close to the reference's; the labels
of ``segment_cloud`` equal to the frozen graph solve run on the
reference's lists (``benchmark/paths/pallas.py``); and the exact path's
spans and counters, which the window path does not report.
"""

import json
import os

import numpy as np
import pytest

from benchmark.harness.check import EIGEN_GAP
from benchmark.paths import pallas as pallas_path
from benchmark.reference.exact_stage1 import exact_lists, exact_stage1
from benchmark.reference.stage1 import morton_order
from buildingsegment_tpu_torch import pipeline
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.utils import make_building_cloud

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CELL = "tls_house_25mm_exact"
_EXACT_SPANS = {"knn.prepare", "knn.exact", "knn.unsort"}
_EXACT_COUNTERS = {"knn_tiles_listed", "knn_query_tiles"}


def _load(rel):
    with open(os.path.join(_ROOT, rel)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cell():
    """The cell's pipeline fields and the limits of its comparison."""
    cfg = _load(f"benchmark/configs/{_CELL}.json")
    limits = _load(f"benchmark/workloads/{_CELL}.cli_loop.json")["limits"]
    return cfg["pipeline"], limits


@pytest.fixture(scope="module")
def scene():
    """A small house at the cell's 25 mm spacing (~9k points)."""
    pts, _ = make_building_cloud(
        seed=7, spacing_mm=25.0, width_mm=1100.0, depth_mm=800.0,
        wall_h_mm=700.0, ridge_h_mm=1000.0, noise_mm=8.0)
    return pts


@pytest.fixture(scope="module")
def run(scene, cell):
    """``segment_cloud`` on the exact path, with the lists, normals and
    curvature ``estimate_normals`` saw and gave (input order)."""
    params, _ = cell
    got = []
    with pallas_path.capture(got):
        out = pipeline.segment_cloud(HostPointCloud(positions=scene),
                                     PipelineConfig(**params), device="cpu")
    assert len(got) == 1 and got[0]["knn_calls"] == 1
    return out, got[0]


@pytest.fixture(scope="module")
def ref(run):
    out, _ = run
    return exact_stage1(out.cloud.positions, k=50, radius=100.0, max_nn=50,
                        orient_z=True, device="cpu")


def _brute(p, k, rank):
    """Each point's list by definition: itself, then the k − 1 others by
    (squared distance, Morton rank)."""
    p = p.astype(np.int64)
    n = len(p)
    d = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    idx = np.repeat(np.arange(n)[:, None], k, 1)
    dist = np.zeros((n, k), np.int64)
    m = min(k - 1, n - 1)
    for i in range(n):
        others = np.array([j for j in range(n) if j != i])
        o = others[np.lexsort((rank[others], d[i, others]))][:m]
        idx[i, 1:m + 1] = o
        dist[i, 1:m + 1] = d[i, o]
    return idx, dist


def _rank(p):
    rank = np.empty(len(p), np.int64)
    rank[morton_order(p)] = np.arange(len(p))
    return rank


@pytest.mark.parametrize("case", ["house", "ties", "cube", "few"])
def test_grid_search_by_definition(case):
    """The grid search's lists equal a brute force over every pair: on a
    house at 60 mm, with duplicated points (ties at 0 and elsewhere,
    ordered by Morton rank), on a dense random cube (the far rings and
    the search over every point), and with fewer points than a list
    holds (the empty slots list the point itself)."""
    rng = np.random.default_rng(11)
    if case == "house":
        p, _ = make_building_cloud(seed=3, spacing_mm=60.0, width_mm=1500.0,
                                   depth_mm=1000.0, wall_h_mm=800.0,
                                   ridge_h_mm=1100.0, noise_mm=8.0)
        p = p[:900]
    elif case == "ties":
        p = rng.integers(0, 200, (300, 3))
        p = np.concatenate([p, p[:40], p[:5]])
    elif case == "cube":
        p = rng.integers(0, 2000, (400, 3))
    else:
        p = rng.integers(0, 500, (20, 3))
    p = (p - p.min(0)).astype(np.int32)
    rank = _rank(p)
    idx, d2 = exact_lists(p, 50, "cpu", rank)
    want_i, want_d = _brute(p, 50, rank)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_array_equal(d2.numpy(), want_d)


def test_knn_pallas_lists_equal_the_reference(run, ref):
    """The lists the pipeline's one ``knn_pallas`` call made (#14's plain
    version, in the Morton order) and scattered back to the input order
    equal the reference's bit for bit, indices and squared distances."""
    out, got = run
    n = len(out.plane_idx)
    np.testing.assert_array_equal(got["neigh_idx"][:n], ref["neigh_idx"])
    np.testing.assert_array_equal(
        got["neigh_sq_dist"][:n].astype(np.float64), ref["neigh_sq_dist"])


def test_determined_normals_and_curvature_within_the_cells_limits(
        run, ref, cell):
    """Curvature within the cell's limit; the determined normals, which
    the cell reads but does not limit, below the smallest gap the TF32
    control read on the card (PERF.md section 2)."""
    _, limits = cell
    out, got = run
    n = len(out.plane_idx)
    nums = pallas_path.compare_stage1(got, ref, n)
    assert nums["neighbour_mismatch"] == 0.0
    assert nums["kth_dist_gap"] == 0.0
    assert nums["curvature_gap"] <= limits["curvature_gap"]
    assert nums["normal_gap_determined"] < 3.05e-7
    # most of a house's normals are determined
    assert np.mean(ref["eigen_gap"] >= EIGEN_GAP) > 0.9


def test_labels_equal_the_frozen_graph_solve(run, scene, cell):
    """``segment_cloud(knn_method="pallas")`` labels, plane table and
    colours equal the frozen copy's hybrid normals and graph solve run on
    the reference's own lists."""
    params, _ = cell
    out, _ = run
    cap = PipelineConfig(**params).padded_count(len(scene))
    want = pallas_path.reference(scene, params, capacity=cap, device="cpu")
    assert out.num_planes == want.num_planes >= 3
    np.testing.assert_array_equal(out.plane_idx, want.labels)
    np.testing.assert_array_equal(out.plane_counts, want.plane_counts)
    np.testing.assert_array_equal(out.plane_normals, want.plane_normals)
    np.testing.assert_array_equal(out.plane_centers, want.plane_centers)
    np.testing.assert_array_equal(out.cloud.colors, want.colors)


def test_exact_spans_and_counters(run, scene, cell):
    """The exact path times #14's preparation, launch and scatter inside
    ``knn`` and reports the tiles listed; the window path reports none
    of them."""
    params, _ = cell
    out, _ = run
    assert _EXACT_SPANS | {"knn", "normals", "stage1"} <= set(out.timings)
    assert sum(out.timings[s] for s in _EXACT_SPANS) <= out.timings["knn"]
    diag = out.diagnostics
    assert _EXACT_COUNTERS <= set(diag)
    assert out.num_sweeps > 0
    cap = PipelineConfig(**params).padded_count(len(scene))
    assert diag["knn_query_tiles"] == cap // 128
    assert (diag["knn_query_tiles"] <= diag["knn_tiles_listed"]
            <= diag["knn_query_tiles"] * (cap // 1024))
    window = pipeline.segment_cloud(
        HostPointCloud(positions=scene),
        PipelineConfig(**dict(params, knn_method="window")), device="cpu")
    assert not (_EXACT_SPANS | {"knn", "normals"}) & set(window.timings)
    assert not _EXACT_COUNTERS & set(window.diagnostics)
