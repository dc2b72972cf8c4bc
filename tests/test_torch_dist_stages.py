"""The port's sharded stages against one device and against JAX.

Each case spawns a gloo group on the CPU (one process a rank), runs a
stage with ``group=`` on the rank's rows of one Morton-sorted cloud and
concatenates the ranks' rows:

* against the port's one-device run of the same stage: bit for bit (the
  sweeps see the neighbours' rows through ring halos, and the one-device
  fills past the global edges) — the stats sweep (kernel #3), its block
  form (#15), the fused kNN sweep, the seed rule (#4, and #16 in block
  form), one label sweep (#1) and one refinement sweep (#6) on inputs
  whose masked rows near the shard edges carry junk positions, and the
  finalize's block sums (#11, #13) continued from rank to rank over
  shards of whole blocks;
* against the JAX package's counterparts under ``shard_map`` on 2 CPU
  devices: ``kth_sq_dist`` and the seeds exactly, the fused sweep's
  neighbour lists exactly, normals at tests/test_torch_stats.py's bound
  (99th-percentile angle < 0.2°) and curvature at the same percentile
  within 1e-4.  The normals finish is the one place the packages round
  differently (two closed-form 3×3 eigen solvers): on this cloud the
  port's one-device run, like its sharded run, differs from JAX's by up
  to 1.8e-4 in curvature on 25 of 11,264 rows whose smallest eigenvalue
  is near 0, so the curvature is held per percentile as the normals are.
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.dist import shard_rows, spawn
from buildingsegment_tpu_torch.ops import window_sweep as ws
from buildingsegment_tpu_torch.ops.adopt import adopt_table, plane_adopt
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.segsum import plane_payload_moment_sums
from buildingsegment_tpu_torch.ops.stats_sweep import knn_normals_window_stats
from buildingsegment_tpu_torch.seg.region_grow import window_seeds
from buildingsegment_tpu_torch.utils import make_building_cloud

SPAWN_TIMEOUT_S = 120
K, W, RADIUS, MAX_NN = 15, 48, 300.0, 50
SEED_W = 16
TH, COS, EDGE2 = 300.0, 0.88, 600.0 ** 2


def _cloud():
    """tests/test_dist.py's cloud (seed 11, 250 mm), capacity 11,264,
    sorted; every 7th valid row masked out with its position moved 50 m
    away (junk behind a false mask, near every shard edge too)."""
    pts, _ = make_building_cloud(seed=11, spacing_mm=250.0, noise_mm=10.0)
    cap = 11264
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos),
                                 torch.from_numpy(mask))
    spos = spos.float()
    junk = torch.zeros(cap, dtype=torch.bool)
    junk[::7] = True
    junk &= smask
    spos[junk] = spos[junk] + 50_000.0
    smask = smask & ~junk
    return spos.contiguous(), smask.contiguous()


def _sweep_inputs(spos, smask):
    """Labels, region models and a plane table for one label sweep and
    one refinement sweep, made from a seed."""
    rng = np.random.default_rng(3)
    n = spos.shape[0]
    inf = n
    label = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    label[torch.from_numpy(rng.random(n) < 0.3)] = inf
    models = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    models[:, :3] /= models[:, :3].norm(dim=1, keepdim=True)
    models[:, 3:] = spos + torch.from_numpy(
        rng.normal(scale=100.0, size=(n, 3)).astype(np.float32))
    pid = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    table = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    table[:, :3] /= table[:, :3].norm(dim=1, keepdim=True)
    table[:, 3] = (table[:, :3] * spos[:16]).sum(1)
    return label, models, pid, table, inf


#: rows of the finalize sums' inputs: whole 1,024-row blocks on each
#: rank at world 2 and 4 (the sums are the one-device bits only then)
SUM_ROWS = 8192


def _sum_inputs(spos, smask, normals):
    """Inputs of the finalize's two block sums (#11, #13) on the first
    SUM_ROWS rows: plane ids, payload rows, centres, the adoption table."""
    rng = np.random.default_rng(4)
    pos, mask = spos[:SUM_ROWS], smask[:SUM_ROWS]
    ids = torch.from_numpy(rng.integers(0, 300, SUM_ROWS).astype(np.int32))
    ids[~mask] = 4096
    payload = torch.cat([torch.ones(SUM_ROWS, 1), normals[:SUM_ROWS], pos,
                         (pos * pos).sum(1, keepdim=True)], 1).contiguous()
    q = pos[torch.from_numpy(rng.integers(0, SUM_ROWS, 300))]
    nk = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    nk = nk / nk.norm(dim=1, keepdim=True)
    ck = pos[torch.from_numpy(rng.integers(0, SUM_ROWS, 128))]
    table = adopt_table(nk, ck, (nk * ck).sum(1), (ck * ck).sum(1),
                        torch.full((128,), 1e12), torch.ones(128, dtype=bool))
    lane_rows = torch.arange(128, dtype=torch.int32)
    holes = mask & torch.from_numpy(rng.random(SUM_ROWS) < 0.5)
    return ids, payload, q, table, lane_rows, holes


def _sums(group, spos, smask, normals):
    """#11's sums and moments and #13's lane sums; with ``group`` this
    rank's rows, continued from rank to rank."""
    ids, payload, q, table, lane_rows, holes = _sum_inputs(spos, smask,
                                                           normals)
    if group is not None:
        rows = shard_rows(SUM_ROWS, group)
        ids, payload, holes = ids[rows], payload[rows], holes[rows]

    def paymom(init):
        return plane_payload_moment_sums(ids, payload, q, 300,
                                         table_cap=4096, init=init)

    def adopt(init):
        return plane_adopt(payload, holes, table, lane_rows,
                           th_thickness=2000.0, th_cos=0.0, init=init)[2]

    if group is None:
        return {"paymom": paymom(None), "adopt": adopt(None)}
    return {"paymom": group.fold(paymom, [(4096, 8), (4096, 6)]),
            "adopt": group.fold(adopt, (128, 8))}


def _one_device(spos, smask, normals):
    """The stages on the whole cloud, no group."""
    out = {}
    out["stats"] = knn_normals_window_stats(
        spos, smask, K, window=W, radius=RADIUS, max_nn=MAX_NN)
    out["stats_mxu"] = knn_normals_window_stats(
        spos, smask, K, window=W, radius=RADIUS, max_nn=MAX_NN,
        rank_mode="mxu")
    out["fused"] = knn_normals_window_sorted(
        spos, smask, 16, window=W, radius=RADIUS, max_nn=MAX_NN)
    dk = out["stats"][0]
    for mode in (None, "mxu"):
        out[f"seeds_{mode}"] = window_seeds(
            spos, normals, smask, dk, window=SEED_W, seed_mode=mode)
    label, models, pid, table, inf = _sweep_inputs(spos, smask)
    pos = tuple(spos[:, d].contiguous() for d in range(3))
    nrm = tuple(normals[:, d].contiguous() for d in range(3))
    m = tuple(models[:, d].contiguous() for d in range(6))
    out["label_sweep"] = ws.label_sweep(
        pos, nrm, m[:3], m[3:], label, smask, w=SEED_W, th_thickness=TH,
        th_normal_cos=COS, edge_gate2=EDGE2, inf_label=inf)
    out["refine_sweep"] = ws.refine_sweep(
        pos, nrm, smask, pid, table, 9, w=SEED_W, th_thickness=TH,
        th_normal_cos=COS, edge_gate2=EDGE2, clean=True)
    out.update(_sums(None, spos, smask, normals))
    return out


def _sharded(group, spos, smask, normals):
    """The same stages on this rank's rows with ``group``."""
    rows = shard_rows(spos.shape[0], group)
    sp, sm, nr = spos[rows], smask[rows], normals[rows]
    out = {}
    out["stats"] = knn_normals_window_stats(
        sp, sm, K, window=W, radius=RADIUS, max_nn=MAX_NN, group=group)
    out["stats_mxu"] = knn_normals_window_stats(
        sp, sm, K, window=W, radius=RADIUS, max_nn=MAX_NN, rank_mode="mxu",
        group=group)
    out["fused"] = knn_normals_window_sorted(
        sp, sm, 16, window=W, radius=RADIUS, max_nn=MAX_NN, group=group)
    dk = out["stats"][0]
    for mode in (None, "mxu"):
        out[f"seeds_{mode}"] = window_seeds(
            sp, nr, sm, dk, window=SEED_W, seed_mode=mode, group=group)
    label, models, pid, table, inf = _sweep_inputs(spos, smask)
    pos = tuple(sp[:, d].contiguous() for d in range(3))
    nrm = tuple(nr[:, d].contiguous() for d in range(3))
    hpos, hnrm, hmask = ws.halo_columns(group, SEED_W, pos, nrm, sm)
    hm = group.halo_pad(models[rows], SEED_W, fill=0.0)
    hlab = group.halo_pad(label[rows], SEED_W, fill=inf)
    out["label_sweep"] = ws.label_sweep(
        hpos, hnrm, tuple(hm[:, d] for d in range(3)),
        tuple(hm[:, 3 + d] for d in range(3)), hlab, hmask, w=SEED_W,
        th_thickness=TH, th_normal_cos=COS, edge_gate2=EDGE2,
        inf_label=inf, group=group)
    out["refine_sweep"] = ws.refine_sweep(
        hpos, hnrm, hmask, group.halo_pad(pid[rows], SEED_W, fill=0), table,
        9, w=SEED_W, th_thickness=TH, th_normal_cos=COS, edge_gate2=EDGE2,
        clean=True, group=group)
    # the sums are the same on every rank: keep rank 0's alone
    sums = _sums(group, spos, smask, normals)
    if group.rank == 0:
        out.update(sums)
    return out


def _cat(parts):
    """The ranks' results joined row-wise, leaf by leaf (a key rank 0
    alone holds is rank 0's)."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts]) if k in parts[-1]
                else first[k] for k in first}
    if isinstance(first, tuple):
        return tuple(_cat([p[i] for p in parts]) for i in range(len(first)))
    return torch.cat(parts, 0)


@pytest.fixture(scope="module")
def cloud():
    spos, smask = _cloud()
    _dk, normals, _c = knn_normals_window_stats(
        spos, smask, K, window=W, radius=RADIUS, max_nn=MAX_NN)
    return spos, smask, normals.contiguous()


@pytest.fixture(scope="module")
def one_device(cloud):
    return _one_device(*cloud)


@pytest.fixture(scope="module")
def sharded(cloud):
    return {world: _cat(spawn(_sharded, world, device="cpu", args=cloud,
                              timeout_s=SPAWN_TIMEOUT_S))
            for world in (2, 4)}


STAGES = ("stats", "stats_mxu", "fused", "seeds_None", "seeds_mxu",
          "label_sweep", "refine_sweep", "paymom", "adopt")


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("stage", STAGES)
def test_sharded_stage_equals_one_device(sharded, one_device, world, stage):
    got, want = sharded[world][stage], one_device[stage]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w), stage


def test_sweeps_see_work_at_the_shard_edges(one_device, cloud):
    """The inputs exercise the halos: rows next to a shard edge hop,
    merge, adopt and are seeds, and the label sweep changes labels."""
    _spos, smask, _n = cloud
    n = smask.shape[0]
    edges = torch.zeros(n, dtype=torch.bool)
    for cut in range(n // 4, n, n // 4):
        edges[cut - SEED_W:cut + SEED_W] = True
    new, best = one_device["label_sweep"]
    label = _sweep_inputs(*cloud[:2])[0]
    assert bool(((new != label) & edges).any())
    assert bool(((best < n) & edges).any())
    assert bool((one_device["seeds_None"] & edges).any())


def _jax_sharded(spos, smask, normals, dk):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from buildingsegment_tpu.dist.mesh import POINTS_AXIS as AX
    from buildingsegment_tpu.dist.mesh import make_mesh as jax_make_mesh
    from buildingsegment_tpu.ops.fused import (
        knn_normals_window_sorted as jax_fused,
    )
    from buildingsegment_tpu.ops.stats_sweep import (
        knn_normals_window_stats as jax_stats,
    )
    from buildingsegment_tpu.seg.region_grow import (
        window_seeds as jax_seeds,
    )

    mesh = jax_make_mesh(2)
    row2, row1 = P(AX, None), P(AX)

    def body(sp, sm, nr, d):
        st = jax_stats(sp, sm, K, window=W, radius=RADIUS, max_nn=MAX_NN,
                       axis_name=AX)
        fu = jax_fused(sp, sm, 16, window=W, radius=RADIUS, max_nn=MAX_NN,
                       axis_name=AX)
        seeds = jax_seeds(sp, nr, sm, d, window=SEED_W, axis_name=AX)
        return st + fu + (seeds,)

    out = jax.shard_map(
        body, mesh=mesh, in_specs=(row2, row1, row2, row1),
        out_specs=(row1, row2, row1, row2, row2, row2, row1, row1),
        check_vma=False,
    )(jnp.asarray(spos.numpy()), jnp.asarray(smask.numpy()),
      jnp.asarray(normals.numpy()), jnp.asarray(dk.numpy()))
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def jax_world2(cloud, one_device):
    spos, smask, normals = cloud
    return _jax_sharded(spos, smask, normals, one_device["stats"][0])


def _angles_deg(a, b):
    cos = np.clip(np.abs(np.sum(np.asarray(a) * np.asarray(b), -1)), 0, 1)
    return np.degrees(np.arccos(cos))


def test_stats_world2_matches_jax(sharded, jax_world2, cloud):
    smask = cloud[1].numpy()
    dk, normals, curv = (t.numpy() for t in sharded[2]["stats"])
    jdk, jn, jc = jax_world2[:3]
    np.testing.assert_array_equal(dk, jdk)
    assert np.percentile(_angles_deg(normals, jn)[smask], 99) < 0.2
    assert np.percentile(np.abs(curv - jc)[smask], 99) < 1e-4


def test_fused_world2_matches_jax(sharded, jax_world2, cloud):
    smask = cloud[1].numpy()
    nb_i, nb_d, normals, _c = (t.numpy() for t in sharded[2]["fused"])
    ji, jd, jn = jax_world2[3:6]
    np.testing.assert_array_equal(nb_d, jd)
    np.testing.assert_array_equal(nb_i, ji)
    assert np.percentile(_angles_deg(normals, jn)[smask], 99) < 0.2


def test_window_seeds_world2_matches_jax(sharded, jax_world2):
    np.testing.assert_array_equal(sharded[2]["seeds_None"].numpy(),
                                  jax_world2[7])


def test_sums_see_work(one_device):
    """The block sums have rows in every block and adopted rows."""
    sums, moments = one_device["paymom"]
    assert int(sums[:, 0].sum()) > SUM_ROWS // 2
    assert float(moments.abs().sum()) > 0
    assert int(one_device["adopt"][:, 0].sum()) > SUM_ROWS // 8
