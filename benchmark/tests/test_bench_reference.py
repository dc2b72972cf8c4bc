"""The reference's own stage 1 and the control's TF32 rounding, on the
CPU: the Morton order against keys built one point at a time, the window
statistics against their definition and against the frozen copy, and
the control moving what it should."""

import numpy as np
import pytest
import torch

from benchmark.harness.scenes import make_building_cloud
from benchmark.reference.plain.ops.stats_sweep import knn_normals_window_stats
from benchmark.reference.precision import tf32_products, tf32_round
from benchmark.reference.stage1 import morton_order, window_stage1

PARAMS = dict(k=15, window=48, radius=100.0, max_nn=50)


def _key(p):
    return sum(((int(p[a]) >> b) & 1) << (3 * b + a)
               for b in range(20) for a in range(3))


def _cloud(seed=3):
    pts, _ = make_building_cloud(seed, width_mm=1200.0, depth_mm=900.0,
                              wall_h_mm=600.0, ridge_h_mm=900.0,
                              spacing_mm=40.0, noise_mm=8.0)
    return (pts - pts.min(axis=0)).astype(np.int32)


def test_morton_order_by_keys_one_point_at_a_time():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 1 << 20, (300, 3)).astype(np.int32)
    pts[7] = pts[3]  # a tie keeps the input order
    keys = [_key(p) for p in pts]
    assert list(morton_order(pts)) == sorted(range(len(pts)),
                                             key=lambda i: (keys[i], i))
    with pytest.raises(ValueError):
        morton_order(np.array([[1 << 20, 0, 0]], np.int32))


def test_window_statistics_by_their_definition():
    rng = np.random.default_rng(1)
    pts = rng.integers(0, 400, (120, 3)).astype(np.int32)
    out = window_stage1(pts, device="cpu", **PARAMS)
    spos = pts[morton_order(pts)].astype(np.float64)
    assert np.array_equal(out["spos"], spos.astype(np.int32))
    for i in (0, 17, 60, 119):
        lo, hi = max(0, i - 48), min(len(pts), i + 49)
        cand = [j for j in range(lo, hi) if j != i]
        d = np.sort(((spos[cand] - spos[i]) ** 2).sum(1))
        assert out["kth_sq_dist"][i] == d[13]
        cap = min(d[48] if len(d) > 48 else np.inf, 1e4)
        near = [j for j in cand if ((spos[j] - spos[i]) ** 2).sum() <= cap]
        nb = np.concatenate([spos[near], spos[i:i + 1]])
        w, v = np.linalg.eigh(np.cov(nb.T, bias=True))
        if len(nb) >= 3:
            assert 1 - abs(v[:, 0] @ out["normals"][i]) < 1e-9
            assert out["curvature"][i] == pytest.approx(w[0] / w.sum())
        else:
            assert list(out["normals"][i]) == [0.0, 0.0, 1.0]
    assert np.all(out["normals"][:, 2] >= 0)


def test_a_plane_has_its_normal_and_no_curvature():
    g = np.stack(np.meshgrid(np.arange(0, 1000, 25), np.arange(0, 800, 25),
                             indexing="ij"), -1).reshape(-1, 2)
    # jittered, so that no neighbourhood lies on one line
    g = g + np.random.default_rng(2).integers(0, 9, g.shape)
    pts = np.concatenate([g, np.full((len(g), 1), 500)], 1).astype(np.int32)
    out = window_stage1(pts, device="cpu", **PARAMS)
    assert np.allclose(out["normals"], [0.0, 0.0, 1.0], atol=1e-9)
    assert np.allclose(out["curvature"], 0.0, atol=1e-12)


def test_agrees_with_the_frozen_copy():
    pts = _cloud()
    out = window_stage1(pts, device="cpu", **PARAMS)
    from benchmark.reference.plain.core.morton import morton_sort

    spos, smask, _ = morton_sort(torch.from_numpy(pts),
                                 torch.ones(len(pts), dtype=torch.bool),
                                 True)
    dk, nrm, curv = knn_normals_window_stats(
        spos.float(), smask, 15, window=48, radius=100.0, max_nn=50)
    assert np.array_equal(out["spos"], spos.numpy())
    assert np.array_equal(out["kth_sq_dist"], dk.numpy().astype(np.float64))
    cos = np.abs(np.sum(out["normals"] * nrm.numpy(), 1))
    assert np.max(1 - cos) < 1e-3
    assert np.max(np.abs(out["curvature"] - curv.numpy())) < 1e-3


def test_tf32_round():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 2047.0, 2049.0,
                      -2049.0, 2051.0, 0.0])
    assert tf32_round(x).tolist() == [1.0, 1 + 2 ** -9, 2047.0, 2048.0,
                                      -2048.0, 2052.0, 0.0]


def test_the_control_moves_normals_and_curvature():
    pts = _cloud()
    ref = window_stage1(pts, device="cpu", **PARAMS)
    with tf32_products():
        ctl = window_stage1(pts, device="cpu", **PARAMS)
    assert ctl["normals"].dtype == np.float32
    # integer offsets below 2^11 are exact in TF32: the order and the
    # distances do not move, the covariance does
    assert np.array_equal(ctl["spos"], ref["spos"])
    assert np.max(np.abs(ctl["curvature"] - ref["curvature"])) > 1e-5
    assert np.max(1 - np.abs(np.sum(ctl["normals"] * ref["normals"], 1))) \
        > 1e-7
