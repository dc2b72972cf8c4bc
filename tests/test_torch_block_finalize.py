"""The multigrid finalize's spans and counters (``seg/coarse.py``) on the
CPU, through ``segment_cloud`` on the window path, on two scenes: a small
cluttered city block (``make_block_cloud``: two houses on one ground at
60 mm, 5% scatter) and a field of 144 flat patches at 144 heights, whose
table passes the 128 adoption lanes and culls most of its roots.

* ``mg.merge``, ``mg.adopt`` and ``mg.cull`` lie inside ``mg.finalize``
  in a trace, and their times inside its time;
* each of ``FINALIZE_COUNTERS`` and ``finalize_rows`` equals a recount
  in numpy (float64) from the outermost finalize's own inputs and
  outputs, ``unlabeled_points`` the labels' −1s, and the counters add
  up to the labels: the unlabeled points are the holes not adopted plus
  the members of the culled roots, the planes the live roots less the
  culled ones;
* the labels (a digest), the planes and ``host_syncs`` are those the
  solve gave before it had the spans and counters;
* ``spacing_hint_mm`` is ``spacing_bucket_mm(estimate_spacing_mm(...))``
  of the scan.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.core.quantize import (
    estimate_spacing_mm,
    spacing_bucket_mm,
)
from buildingsegment_tpu_torch.io.ply import HostPointCloud
from buildingsegment_tpu_torch.pipeline import segment_cloud
from buildingsegment_tpu_torch.profiling import TRACE_FILE, trace
from buildingsegment_tpu_torch.seg import coarse
from buildingsegment_tpu_torch.utils.synthetic import make_block_cloud

_CFG = PipelineConfig(knn_method="window")
_SPANS = ("mg.merge", "mg.adopt", "mg.cull")
#: planes, host_syncs and the sha256 of the int32 labels of each scene,
#: as the solve gave them before the finalize had spans and counters
_BEFORE = {
    "block": (13, 10, "5bb91bb921a32d11578e122d995633a5"
                      "82a0d64df6ea21a7cf69a5a7ba8fd420"),
    "patches": (60, 6, "6cf7db3a88d4f3048434131b4b3c445b"
                       "980ff2a0e3cc69d5e020f327bfb7ec20"),
}


def _patches(side=12, spacing_mm=60.0, noise_mm=4.0):
    """side² horizontal squares, 0.9 to 1.5 m wide (225 to 625 points),
    on a 2.5 m grid, each 500 mm above the last: no two are coplanar."""
    rng = np.random.default_rng(3)
    parts = []
    for k in range(side * side):
        i, j = divmod(k, side)
        nu = int((900.0 + 600.0 * ((k * 7) % side) / (side - 1))
                 / spacing_mm)
        g = (np.arange(nu)[:, None]
             + rng.uniform(0.25, 0.75, (nu, nu))) * spacing_mm
        h = (np.arange(nu)[None, :]
             + rng.uniform(0.25, 0.75, (nu, nu))) * spacing_mm
        z = 500.0 * k + rng.normal(0.0, noise_mm, (nu, nu))
        parts.append(np.stack([g.ravel() + 2500.0 * i,
                               h.ravel() + 2500.0 * j, z.ravel()], 1))
    pts = np.concatenate(parts)
    pts = pts[rng.permutation(len(pts))]
    return np.round(pts - pts.min(0)).astype(np.int32)


def _scene(name):
    if name == "block":
        return make_block_cloud(seed=1, nx=2, ny=1, spacing_mm=60.0,
                                clutter_frac=0.05)[0]
    return _patches()


def _spy(fn, calls):
    def wrap(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append({"args": args, "out": out})
        return out
    return wrap


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each scene's output, trace events and the finalize helpers' calls
    (the last of each is the outermost level's)."""
    got = {}
    for name in _BEFORE:
        pts = _scene(name)
        calls = {"merge": [], "adopt": []}
        log = str(tmp_path_factory.mktemp(name))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(coarse, "_merge_coplanar",
                       _spy(coarse._merge_coplanar, calls["merge"]))
            mp.setattr(coarse, "_adopt_holes",
                       _spy(coarse._adopt_holes, calls["adopt"]))
            with trace(log, device="cpu"):
                out = segment_cloud(HostPointCloud(positions=pts), _CFG,
                                    device="cpu")
        with open(os.path.join(log, TRACE_FILE)) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if str(e.get("cat", "")).lower() == "user_annotation"]
        got[name] = dict(pts=pts, out=out, events=events, calls=calls)
    return got


def _np(t):
    return t.double().numpy() if t.is_floating_point() else t.numpy()


def _recount(merge, adopt, th_point_count, th_thickness):
    """The outermost finalize's counters and its culled roots' final
    sizes, recounted in numpy from the helpers' inputs and outputs."""
    acc_o = _np(merge["args"][0])
    acc, parent, acc_m, c_t = (_np(t) for t in merge["out"])
    holes = adopt["args"][6].numpy()
    adopted, acc_f = adopt["out"][0].numpy(), _np(adopt["out"][2])
    n_rows = len(acc_o)
    rows = np.arange(n_rows)
    roots = (parent == rows) & (acc_o[:, 0] > 0)
    culled = roots & ~(acc_f[:, 0].astype(np.int32) > th_point_count)
    # flatness of each merged root: its planes' second moments about the
    # root's plane, over the root's count
    cnt_r = acc[:, 0]
    mean_n = acc[:, 1:4] / np.maximum(cnt_r, 1.0)[:, None]
    n_r = mean_n / np.sqrt(np.maximum((mean_n ** 2).sum(1), 1e-20))[:, None]
    c_r = acc[:, 4:7] / np.maximum(cnt_r, 1.0)[:, None]
    nf, cf = n_r[parent], c_r[parent]
    m = acc_m
    r2n = (m[:, 0] * nf[:, 0] ** 2 + m[:, 1] * nf[:, 1] ** 2
           + m[:, 2] * nf[:, 2] ** 2 + 2 * m[:, 3] * nf[:, 0] * nf[:, 1]
           + 2 * m[:, 4] * nf[:, 0] * nf[:, 2]
           + 2 * m[:, 5] * nf[:, 1] * nf[:, 2])
    off = ((c_t - cf) * nf).sum(1)
    flat_num = np.bincount(parent, weights=r2n + acc_o[:, 0] * off ** 2,
                           minlength=n_rows)
    flat = flat_num / np.maximum(cnt_r, 1.0) <= (0.25 * th_thickness) ** 2
    lanes = np.argsort(-cnt_r, kind="stable")[:coarse.ADOPT_K]
    past = flat & (cnt_r > 0) & ~np.isin(rows, lanes)
    counts = {
        "holes": int(holes.sum()),
        "holes_adopted": int(adopted.sum()),
        "roots_culled": int(culled.sum()),
        "flat_roots_past_lanes": int(past.sum()),
    }
    return counts, n_rows, int(roots.sum()), int(acc_f[culled, 0].sum())


@pytest.mark.parametrize("name", list(_BEFORE))
def test_spans_inside_the_finalize(runs, name):
    run = runs[name]
    t = run["out"].timings
    assert sum(t[s] for s in _SPANS) <= t["mg.finalize"]
    fins = [e for e in run["events"] if e["name"] == "mg.finalize"]
    # one finalize a multigrid level, each holding its three parts
    assert len(fins) == _CFG.seg_levels
    for s in _SPANS:
        inner = [e for e in run["events"] if e["name"] == s]
        assert len(inner) == len(fins)
        for e in inner:
            assert any(f["tid"] == e["tid"] and f["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= f["ts"] + f["dur"]
                       for f in fins), s


@pytest.mark.parametrize("name", list(_BEFORE))
def test_counters_are_a_recount(runs, name):
    run = runs[name]
    out, calls = run["out"], run["calls"]
    diag = out.diagnostics
    counts, n_rows, live_roots, culled_members = _recount(
        calls["merge"][-1], calls["adopt"][-1], _CFG.th_point_count,
        _CFG.th_thickness)
    unlabeled = int((out.plane_idx == -1).sum())
    assert ({k: diag[k] for k in coarse.FINALIZE_COUNTERS}
            == dict(counts, unlabeled_points=unlabeled))
    assert diag["finalize_rows"] == n_rows
    assert out.num_planes == live_roots - diag["roots_culled"]
    assert diag["unlabeled_points"] == (
        diag["holes"] - diag["holes_adopted"] + culled_members)
    assert diag["holes_adopted"] > 0
    if name == "patches":
        # past the lanes, and most roots under th_point_count
        assert diag["finalize_rows"] > coarse.ADOPT_K
        assert diag["flat_roots_past_lanes"] > 0
        assert diag["roots_culled"] > out.num_planes


@pytest.mark.parametrize("name", list(_BEFORE))
def test_labels_and_syncs_as_before(runs, name):
    out = runs[name]["out"]
    planes, syncs, digest = _BEFORE[name]
    assert out.num_planes == planes
    assert out.host_syncs == syncs
    labels = out.plane_idx.astype("<i4").tobytes()
    assert hashlib.sha256(labels).hexdigest() == digest


@pytest.mark.parametrize("name", list(_BEFORE))
def test_spacing_hint_is_the_hosts(runs, name):
    pts = runs[name]["pts"]
    want = spacing_bucket_mm(estimate_spacing_mm(pts))
    assert runs[name]["out"].diagnostics["spacing_hint_mm"] == want > 0
