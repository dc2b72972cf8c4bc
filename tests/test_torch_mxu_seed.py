"""The port's block-form seed sweep (#16) against the JAX package's, and
the block-form variant path end to end.

``ops.stats_mxu.seed_sweep_mxu_reference`` (the plain version of the
port's kernel) is held against ``seed_sweep_mxu`` (``_seed_mxu_kernel``)
run in interpret mode on the CPU, in the regimes of the JAX package's
own test (tests/test_stats_mxu.py): bit for bit at small span (signed
and unsigned), fewer than 0.1% of the flags different at building span.

The routing of ``seg_seed_mode``: "mxu" takes the block form, None,
"pair" and "sym" the exact sweep's bits, anything else raises.

The slice: ``segment_cloud`` under ``PipelineConfig(stats_rank_mode=
"mxu", seg_seed_mode="mxu")`` (the window path forced on a small scene).
On the CPU the JAX package runs its exact XLA path whatever the modes,
while the port runs the block-form plain versions, so the two compute
different roundings: the contract is that of
tests/test_forced_tpu_path.py — the same plane count, cross agreement
≥ 0.99 and truth agreement within 0.01.  ``segment_file`` and
``segment_files`` route the fields too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.config import PipelineConfig as JaxPipelineConfig
from buildingsegment_tpu.core.morton import morton_sort as jax_morton_sort
from buildingsegment_tpu.io.ply import HostPointCloud as JaxHostPointCloud
from buildingsegment_tpu.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu.ops.stats_mxu import seed_sweep_mxu
from buildingsegment_tpu.ops.window_sweep import make_dyn_row, make_spine
from buildingsegment_tpu.pipeline import segment_cloud as jax_segment_cloud
from buildingsegment_tpu.utils.quality import bij_agreement
from buildingsegment_tpu.utils.synthetic import make_building_cloud
from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.io.ply import HostPointCloud, write_ply
from buildingsegment_tpu_torch.ops import stats_sweep as stats_mod
from buildingsegment_tpu_torch.ops.stats_mxu import seed_sweep_mxu_reference
from buildingsegment_tpu_torch.ops.window_sweep import seed_sweep_reference
from buildingsegment_tpu_torch.pipeline import (
    segment_cloud,
    segment_file,
    segment_files,
)
from buildingsegment_tpu_torch.seg import region_grow
from buildingsegment_tpu_torch.seg.region_grow import window_seeds

CAP, TILE = 2048, 1024
TH, CTH = 300.0, 0.88
BUILDING = dict(seed=5, spacing_mm=280.0, width_mm=5000.0, depth_mm=4000.0,
                wall_h_mm=3000.0, ridge_h_mm=4000.0)
_MXU = dict(knn_method="window", stats_rank_mode="mxu", seg_seed_mode="mxu")


def _padded(pts):
    pos = np.full((CAP, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(CAP, bool)
    mask[: len(pts)] = True
    spos, smask, _ = jax_morton_sort(jnp.asarray(pos), jnp.asarray(mask))
    return np.array(spos, np.float32), np.array(smask)


def _cols(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return tuple(t[:, d].contiguous() for d in range(3))


def _both(spos, smask, nrm, dk, **kw):
    spine = make_spine(
        tuple(jnp.asarray(spos[:, d]) for d in range(3)),
        tuple(jnp.asarray(nrm[:, d]) for d in range(3)),
        jnp.asarray(smask.astype(np.float32)), kw["w"], TILE,
    )
    dyn = make_dyn_row(jnp.asarray(dk), 0.0, kw["w"], TILE)
    bad = np.asarray(seed_sweep_mxu(spine, dyn, spos.shape[0], tile=TILE,
                                    interpret=True, **kw))
    got = seed_sweep_mxu_reference(
        _cols(spos), _cols(nrm), torch.from_numpy(smask),
        torch.from_numpy(dk), **kw)
    return smask & (bad < 0.5), got.numpy()


@pytest.mark.parametrize("signed", [False, True])
def test_seed_mxu_small_span_bit_exact(signed):
    rng = np.random.default_rng(3)
    spos, smask = _padded(rng.integers(0, 250, (1500, 3)).astype(np.int32))
    nrm = rng.normal(size=(CAP, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dk = rng.uniform(100.0, 4000.0, CAP).astype(np.float32)
    want, got = _both(spos, smask, nrm, dk, w=16, th_thickness=30.0,
                      th_normal_cos=CTH, signed=signed)
    assert want.sum() > 10 and (smask & ~want).sum() > 100
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def house():
    """The house at 280 mm spacing, sorted, with the JAX package's
    normals and seed balls (radius ~2 spacings)."""
    spos, smask = _padded(make_building_cloud(**BUILDING)[0])
    _, nb_d, nrm, _ = knn_normals_window_sorted(
        jnp.asarray(spos), jnp.asarray(smask), 16, window=32, radius=600.0,
        max_nn=50)
    return spos, smask, np.array(nrm), np.array(nb_d[:, 14])


def test_seed_mxu_building_span(house):
    spos, smask, nrm, dk = house
    want, got = _both(spos, smask, nrm, dk, w=16, th_thickness=TH,
                      th_normal_cos=CTH, signed=False)
    assert want.sum() > 100 and (smask & ~want).sum() > 100
    mism = np.mean(want != got)
    assert mism < 0.001, f"seed flags differ on {mism:.4%} of the rows"


@pytest.mark.parametrize("mode", [None, "pair", "sym", "mxu"])
def test_seed_mode_routes(house, mode):
    """None, "pair" and "sym" give the exact sweep's bits, "mxu" the
    block form's."""
    spos, smask, nrm, dk = house
    kw = dict(w=16, th_thickness=TH, th_normal_cos=CTH, signed=False)
    args = (_cols(spos), _cols(nrm), torch.from_numpy(smask),
            torch.from_numpy(dk))
    ref = (seed_sweep_mxu_reference if mode == "mxu"
           else seed_sweep_reference)(*args, **kw)
    got = window_seeds(torch.from_numpy(spos), torch.from_numpy(nrm),
                       torch.from_numpy(smask), torch.from_numpy(dk),
                       window=16, th_thickness=TH, th_normal_cos=CTH,
                       seed_mode=mode)
    assert torch.equal(got, ref)


def test_seed_mode_unknown_raises(house):
    spos, smask, nrm, dk = house
    with pytest.raises(ValueError, match="seed_mode"):
        window_seeds(torch.from_numpy(spos), torch.from_numpy(nrm),
                     torch.from_numpy(smask), torch.from_numpy(dk),
                     seed_mode="bogus")


@pytest.fixture(scope="module")
def scene():
    return make_building_cloud(
        seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
        wall_h_mm=3000.0, ridge_h_mm=4000.0,
    )


def test_segment_cloud_mxu_matches_jax(scene):
    pts, truth = scene
    a = jax_segment_cloud(JaxHostPointCloud(positions=pts),
                          JaxPipelineConfig(**_MXU))
    b = segment_cloud(HostPointCloud(positions=pts), PipelineConfig(**_MXU),
                      device="cpu")
    assert b.num_planes == a.num_planes >= 5
    cross = bij_agreement(a.plane_idx, b.plane_idx)
    assert cross >= 0.99, cross
    ag_a = bij_agreement(truth, a.plane_idx)
    ag_b = bij_agreement(truth, b.plane_idx)
    assert abs(ag_a - ag_b) < 0.01, (ag_a, ag_b)


@pytest.mark.parametrize("entry", ["segment_cloud", "segment_file",
                                   "segment_files"])
def test_entry_points_route_the_modes(scene, tmp_path, monkeypatch, entry):
    """Each entry point runs the block-form stats and seed sweeps under
    the config's fields, once per scan, and the exact ones not at all."""
    calls = {"stats_mxu": 0, "seed_sweep_mxu": 0, "stats_sweep": 0,
             "seed_sweep": 0}

    def count(mod, name):
        fn = getattr(mod, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, call)

    count(stats_mod, "stats_mxu")
    count(stats_mod, "stats_sweep")
    count(region_grow, "seed_sweep_mxu")
    count(region_grow, "seed_sweep")
    pts = scene[0][::4]
    cfg = PipelineConfig(**_MXU)
    src = str(tmp_path / "scan.ply")
    write_ply(HostPointCloud(positions=pts), src, position_scale=0.001)
    if entry == "segment_cloud":
        outs = [segment_cloud(HostPointCloud(positions=pts), cfg,
                              device="cpu")]
    elif entry == "segment_file":
        outs = [segment_file(src, str(tmp_path / "out.ply"), cfg,
                             device="cpu")]
    else:
        outs = segment_files([src, src], [str(tmp_path / "a.ply"),
                                          str(tmp_path / "b.ply")], cfg,
                             device="cpu")
    assert all(o.num_planes > 0 for o in outs)
    n = len(outs)
    assert calls == {"stats_mxu": n, "seed_sweep_mxu": n, "stats_sweep": 0,
                     "seed_sweep": 0}, calls
