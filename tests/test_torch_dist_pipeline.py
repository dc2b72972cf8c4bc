"""The port's ``sharded_pipeline`` against its one-device run and JAX's.

tests/test_dist.py's cloud (seed 11, 250 mm spacing, 10,768 points,
capacity 11,264, ``normal_radius=1e6``) runs through
``sharded_pipeline`` at world 1 (in this process: a group of one needs
no peers), 2 and 4 (spawned gloo groups on the CPU):

* every world size equals the port's one-device ``run_device_pipeline``
  bit for bit in ``plane_idx``, ``num_planes`` and ``plane_count`` (the
  CPU run takes no compact loop); tests/test_torch_dist_variants.py
  holds the ``mxu`` fields and the single-level path the same way;
* world 2 against the JAX package's ``sharded_pipeline(make_mesh(2))``
  under the forced-path contract of tests/test_forced_tpu_path.py:76-86
  (same plane count, cross agreement ≥ 0.99, truth agreement within
  0.01).

The 8-rank dryrun shape of tests/test_dist.py:117-130 is marked slow.
"""

import dataclasses

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.config import PipelineConfig
from buildingsegment_tpu_torch.dist import ShardGroup, sharded_pipeline, spawn
from buildingsegment_tpu_torch.dist.check import one_device_run
from buildingsegment_tpu_torch.utils import bij_agreement, make_building_cloud

SPAWN_TIMEOUT_S = 120
CFG = PipelineConfig(normal_radius=1e6, pad_to_multiple=1024)
CONFIGS = {
    "default": CFG,
    "mxu": dataclasses.replace(CFG, stats_rank_mode="mxu",
                               seg_seed_mode="mxu"),
    "single_level": dataclasses.replace(CFG, seg_group=1),
}
#: the configurations this file runs
NAMES = ("default",)


def _padded(pts, cap):
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    return pos, mask


def _run(group, pos, mask, names):
    """sharded_pipeline under each named configuration → host arrays."""
    out = {}
    for name in names:
        group.stats.reset()
        fn = sharded_pipeline(group, CONFIGS[name])
        shifted, lo, seg = fn(torch.from_numpy(pos), torch.from_numpy(mask))
        out[name] = dict(
            plane_idx=seg.plane_idx.numpy(), num_planes=seg.num_planes,
            plane_count=seg.plane_count.numpy(),
            plane_normal=seg.plane_normal.numpy(),
            shifted=shifted.numpy(), lo=lo.numpy(),
            num_sweeps=seg.num_sweeps, stats=dict(vars(group.stats)))
    return out


def _one_device(pos, mask, cfg):
    seg, _ms = one_device_run(pos, mask, cfg, "cpu", cfg.seg_compact)
    return dict(plane_idx=seg.plane_idx.numpy(), num_planes=seg.num_planes,
                plane_count=seg.plane_count.numpy())


@pytest.fixture(scope="module")
def cloud():
    pts, truth = make_building_cloud(seed=11, spacing_mm=250.0,
                                     noise_mm=10.0)
    pos, mask = _padded(pts, CFG.padded_count(len(pts)))
    assert (len(pts), pos.shape[0]) == (10768, 11264)
    return pos, mask, truth


@pytest.fixture(scope="module")
def runs(cloud):
    pos, mask, _ = cloud
    world1 = ShardGroup(None, 0, 1, "gloo", "cpu")
    return {
        1: _run(world1, pos, mask, NAMES),
        2: spawn(_run, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                 args=(pos, mask, NAMES))[0],
        4: spawn(_run, 4, device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                 args=(pos, mask, NAMES))[0],
    }


@pytest.fixture(scope="module")
def one_device(cloud):
    pos, mask, _ = cloud
    return {name: _one_device(pos, mask, CONFIGS[name]) for name in NAMES}


def same_labels(got, want):
    np.testing.assert_array_equal(got["plane_idx"], want["plane_idx"])
    assert got["num_planes"] == want["num_planes"]
    np.testing.assert_array_equal(got["plane_count"], want["plane_count"])


@pytest.mark.parametrize("world", (1, 2, 4))
def test_sharded_equals_one_device(runs, one_device, world):
    same_labels(runs[world]["default"], one_device["default"])


def test_sharded_finds_the_planes(runs, cloud):
    """Not a trivial result: planes over most of the cloud."""
    got = runs[2]["default"]
    assert got["num_planes"] >= 5
    assert (got["plane_idx"][cloud[1]] > 0).mean() > 0.8


@pytest.mark.parametrize("world", (2, 4))
def test_outputs_whole_and_shared(runs, world):
    """Every rank returns the whole cloud's shifted positions, bbox and
    labels; the ranks moved halo rows and reduced tables.  The plane
    normals come from block sums (1,024 rows a block) that continue from
    rank to rank; a shard of 11,264 / world rows is not whole blocks, so
    the sums group the rows otherwise and may round otherwise (f32
    reordering: within 1e-6 of the unit normals)."""
    got, one = runs[world]["default"], runs[1]["default"]
    np.testing.assert_array_equal(got["shifted"], one["shifted"])
    np.testing.assert_array_equal(got["lo"], one["lo"])
    np.testing.assert_allclose(got["plane_normal"], one["plane_normal"],
                               rtol=0, atol=1e-6)
    assert got["stats"]["halo_messages"] > 0
    assert got["stats"]["reductions"] > 0
    assert got["stats"]["host_stagings"] == 0  # CPU tensors: no staging


def _jax_sharded_world2(pos, mask):
    import jax.numpy as jnp

    from buildingsegment_tpu.config import PipelineConfig as JaxConfig
    from buildingsegment_tpu.dist.mesh import make_mesh as jax_make_mesh
    from buildingsegment_tpu.dist.sharded import (
        sharded_pipeline as jax_sharded,
    )

    cfg = JaxConfig(normal_radius=1e6, pad_to_multiple=1024)
    _s, _lo, seg = jax_sharded(jax_make_mesh(2), cfg)(jnp.asarray(pos),
                                                       jnp.asarray(mask))
    return np.asarray(seg.plane_idx), int(seg.num_planes)


def test_world2_meets_the_contract_against_jax(runs, cloud):
    pos, mask, truth = cloud
    j_idx, j_planes = _jax_sharded_world2(pos, mask)
    got = runs[2]["default"]
    n = len(truth)
    assert got["num_planes"] == j_planes
    cross = bij_agreement(j_idx[:n], got["plane_idx"][:n])
    assert cross >= 0.99, cross
    ag_j = bij_agreement(truth, j_idx[:n])
    ag_p = bij_agreement(truth, got["plane_idx"][:n])
    assert abs(ag_j - ag_p) < 0.01, (ag_j, ag_p)


def test_shard_must_fit_the_hierarchy():
    """N takes the multigrid path but a shard does not divide by
    seg_group ** seg_levels: the run refuses instead of switching path."""
    # shapes only: the check runs before any collective
    g = ShardGroup(None, 0, 2, "gloo", "cpu")
    pos = torch.zeros((1040, 3), dtype=torch.int32)  # 1040 = 65 · 16
    with pytest.raises(ValueError, match="multiple of 32"):
        sharded_pipeline(g, CFG)(pos, torch.ones(1040, dtype=torch.bool))


def _dryrun(group, pos, mask):
    cfg = PipelineConfig(knn_method="window", pad_to_multiple=1024)
    _s, _lo, seg = sharded_pipeline(group, cfg)(torch.from_numpy(pos),
                                                torch.from_numpy(mask))
    return seg.num_planes, seg.plane_idx.numpy()


@pytest.mark.slow
def test_dryrun_shape_eight_ranks():
    """tests/test_dist.py:117-130: 4,096 points over 8 ranks; equal to
    the one-device run."""
    pts, _ = make_building_cloud(
        seed=0, spacing_mm=50.0, width_mm=3000.0, depth_mm=2500.0,
        wall_h_mm=2000.0, ridge_h_mm=2600.0,
    )
    pos, mask = _padded(pts[:4096], 4096)
    res = spawn(_dryrun, 8, device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                args=(pos, mask))
    assert res[0][0] >= 1
    one = _dryrun(ShardGroup(None, 0, 1, "gloo", "cpu"), pos, mask)
    assert all(r[0] == one[0] for r in res)
    np.testing.assert_array_equal(res[0][1], one[1])
