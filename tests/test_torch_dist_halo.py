"""The port's ring halos, process groups and launcher (``dist/``).

``ring_halo`` / ``halo_pad`` run in spawned gloo groups on the CPU (one
process a rank) and are held against the JAX package's ``halo_pad``
under ``shard_map`` on the virtual 8-device CPU mesh of
tests/conftest.py, exactly: JAX's one-hop ring (tests/test_dist.py:70-88)
and its multi-hop short-shard case (:91-115) at world 2, 4 and 8.  The
port's per-column edge fill, the group's collectives, ``make_mesh``'s
refusals, the multi-host ordering and the launcher's failure paths are
checked on their own.

The rank functions live at module level and this module imports no JAX
at its top: the spawned ranks import it by name.
"""

import os

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.dist import (
    ShardGroup, halo_pad, make_mesh, make_multihost_mesh, ring_halo,
    shard_rows, spawn,
)
from buildingsegment_tpu_torch.dist import mesh as dist_mesh

# (name, rows in all, halo width): one hop when w <= S, else ceil(w/S)
# hops; "short" has fewer rows in all than a halo needs (fill past the
# edge on both sides)
CASES = {
    2: [("one_hop", 16, 3), ("multi_hop", 8, 6), ("short", 4, 5)],
    4: [("one_hop", 32, 2), ("multi_hop", 16, 7), ("short", 8, 9)],
    8: [("one_hop", 32, 2), ("multi_hop", 64, 16), ("short", 16, 40)],
}
SPAWN_TIMEOUT_S = 120


def _port_halos(group):
    """Every case of this world: halo_pad of int32 rows (JAX's fill),
    of [S, 2] f32 rows with a fill a column, and ring_halo's sides."""
    out = {}
    for name, n, w in CASES[group.world]:
        x = torch.arange(n, dtype=torch.int32)
        local = x[shard_rows(n, group)]
        out[name] = halo_pad(local, w, group).numpy()
        two = torch.stack([local.float(), -local.float()], 1)
        out[name + "_cols"] = halo_pad(two, w, group,
                                       fill=[-3e7, 7.0]).numpy()
        left, right = ring_halo(local, w, group, fill=-1)
        out[name + "_sides"] = (left.numpy(), right.numpy())
    out["stats"] = dict(vars(group.stats))
    return out


def _collectives(group):
    """psum / pmin / all_gather / fold on small tables, and the
    multi-host reordering with two fake nodes of two ranks each."""
    r = group.rank
    res = {
        "psum": group.psum(torch.tensor([r, 1], dtype=torch.int32)).tolist(),
        "pmin": group.pmin(torch.tensor([10 - r, r])).tolist(),
        "por": group.psum(torch.tensor([r == 1, False])).tolist(),
        "gather": group.all_gather(torch.full((2,), r)).tolist(),
    }
    try:
        group.psum(torch.ones(2))
    except TypeError:
        res["f32_psum_refused"] = True
    # each rank continues the sums of the ranks before it: rank order
    vals = torch.tensor([1e8, 1.0, -1e8, 0.5], dtype=torch.float32)

    def add(init):
        acc = torch.zeros(2) if init is None else init.clone()
        return acc + vals[r]

    res["fold"] = group.fold(add, (2,)).tolist()
    # ranks 0, 1 on node 1 and ranks 2, 3 on node 0, local ranks 0/1
    os.environ["GROUP_RANK"] = str(1 - r // 2)
    os.environ["LOCAL_RANK"] = str(r % 2)
    mh = make_multihost_mesh(4, device="cpu")
    res["multihost_rank"] = mh.rank
    x = torch.tensor([mh.rank], dtype=torch.int32)
    res["multihost_halo"] = halo_pad(x, 1, mh, fill=-1).tolist()
    return res


def _fails_on_rank_1(group):
    if group.rank == 1:
        raise ValueError("rank 1 refuses")
    group.barrier()
    return group.rank


def _hangs(group):
    """Rank 0 waits for a message rank 1 never sends."""
    if group.rank == 0:
        torch.distributed.recv(torch.empty(1), 1)
    else:
        import time

        time.sleep(60)
    return group.rank


def _pipeline_rank(group):
    from buildingsegment_tpu_torch.dist import sharded_pipeline

    pos = torch.zeros((1024, 3), dtype=torch.int32)
    mask = torch.ones(1024, dtype=torch.bool)
    return sharded_pipeline(group)(pos, mask)[2].num_planes


@pytest.fixture(scope="module")
def port_halos():
    return {world: spawn(_port_halos, world, device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S)
            for world in CASES}


def _jax_halo_pad(n, w, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from buildingsegment_tpu.dist.halo import halo_pad as jax_halo_pad
    from buildingsegment_tpu.dist.mesh import POINTS_AXIS
    from buildingsegment_tpu.dist.mesh import make_mesh as jax_make_mesh

    mesh = jax_make_mesh(world)
    out = jax.shard_map(
        lambda xl: jax_halo_pad(xl, w, POINTS_AXIS), mesh=mesh,
        in_specs=P(POINTS_AXIS), out_specs=P(POINTS_AXIS),
        check_vma=False,
    )(jnp.arange(n, dtype=jnp.int32))
    return np.asarray(out).reshape(world, n // world + 2 * w)


@pytest.mark.parametrize("world,case", [
    (world, name) for world, cases in CASES.items() for name, _, _ in cases
])
def test_halo_pad_matches_jax(port_halos, world, case):
    _, n, w = next(c for c in CASES[world] if c[0] == case)
    want = _jax_halo_pad(n, w, world)
    for r in range(world):
        np.testing.assert_array_equal(port_halos[world][r][case], want[r])


@pytest.mark.parametrize("world", sorted(CASES))
def test_halo_fill_and_sides(port_halos, world):
    """Rows past the global edges take the fill of their column; inside
    they are the neighbours' rows, as in the one-column case."""
    for name, n, w in CASES[world]:
        s = n // world
        glob = np.concatenate([np.full(w, -1), np.arange(n), np.full(w, -1)])
        for r in range(world):
            got = port_halos[world][r]
            want = glob[r * s: r * s + s + 2 * w]
            left, right = got[name + "_sides"]
            np.testing.assert_array_equal(left, want[:w])
            np.testing.assert_array_equal(right, want[-w:])
            cols = got[name + "_cols"]
            inside = want >= 0
            np.testing.assert_array_equal(cols[inside, 0], want[inside])
            np.testing.assert_array_equal(cols[inside, 1], -want[inside])
            assert (cols[~inside, 0] == np.float32(-3e7)).all()
            assert (cols[~inside, 1] == 7.0).all()


def test_halo_counters(port_halos):
    """A hop is one message each way for an interior rank; a halo takes
    ceil(w / S) hops, at most the world size."""
    st = port_halos[8][3]["stats"]
    # per case three halos (int32, [S, 2] f32, ring_halo): one_hop 1 hop,
    # multi_hop ceil(16 / 8) = 2, short min(ceil(40 / 2), 8) = 8
    hops = [1, 2, 8]
    assert st["ring_steps"] == sum(3 * h for h in hops)
    assert st["halo_messages"] == 2 * st["ring_steps"]
    # one_hop moves w rows, the others whole shards of S rows
    row_bytes = [2 * 4, 8 * 4, 2 * 4]
    assert st["halo_bytes"] == sum(
        2 * h * rb * (1 + 2 + 1) for h, rb in zip(hops, row_bytes))


def test_collectives_and_multihost_order():
    res = spawn(_collectives, 4, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    for r, got in enumerate(res):
        assert got["psum"] == [6, 4]
        assert got["pmin"] == [7, 0]
        assert got["por"] == [True, False]
        assert got["gather"] == [0, 0, 1, 1, 2, 2, 3, 3]
        assert got["f32_psum_refused"]
        # ((((0 + 1e8) + 1) − 1e8) + 0.5) in f32, on every rank
        acc = np.float32(0)
        for v in (1e8, 1.0, -1e8, 0.5):
            acc = np.float32(acc + np.float32(v))
        assert got["fold"] == [float(acc)] * 2
        # node 0 holds old ranks 2, 3: they come first
        assert got["multihost_rank"] == {0: 2, 1: 3, 2: 0, 3: 1}[r]
        mr = got["multihost_rank"]
        want = [mr - 1 if mr > 0 else -1, mr, mr + 1 if mr < 3 else -1]
        assert got["multihost_halo"] == want


def test_shard_rows():
    g = ShardGroup(None, 2, 4, "gloo", "cpu")
    assert shard_rows(40, g) == slice(20, 30)
    assert shard_rows(40, None) == slice(0, 40)
    with pytest.raises(ValueError, match="divide"):
        shard_rows(42, g)


def test_world_one_group_needs_no_process_group():
    """At world 1 every collective is local: the halo is the fill."""
    g = ShardGroup(None, 0, 1, "gloo", "cpu")
    x = torch.arange(5, dtype=torch.int32)
    np.testing.assert_array_equal(halo_pad(x, 2, g, fill=9).numpy(),
                                  [9, 9, 0, 1, 2, 3, 4, 9, 9])
    assert g.psum(x).tolist() == x.tolist()
    assert g.fold(lambda init: x.float() + 1, (5,)).tolist() == [1, 2, 3, 4,
                                                                 5]


def test_make_mesh_refuses_another_world(monkeypatch):
    """A group is never shrunk to what exists: asking for 2 ranks in a
    one-process world raises, before any process group starts."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="2-rank group"):
        make_mesh(2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_refuses_cpu_fallback(monkeypatch):
    """device=None means the card: without CUDA it raises and does not
    move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    assert not torch.distributed.is_initialized()


def test_make_mesh_nccl_needs_a_card_a_rank(monkeypatch):
    """NCCL with more ranks than cards raises and names gloo; gloo maps
    the ranks onto the one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        make_mesh(2, backend="nccl")
    assert not torch.distributed.is_initialized()
    assert dist_mesh._pick_device(None, "gloo", 2, 1) == torch.device(
        "cuda", 0)


def test_sharded_pipeline_without_card_raises():
    """The entry point run as a user would, with no device named, on a
    machine without CUDA: the rank raises, the launcher reports it."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_pipeline_rank, 1, device=None, timeout_s=SPAWN_TIMEOUT_S)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 refuses"):
        spawn(_fails_on_rank_1, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def test_spawn_kills_a_hung_group():
    with pytest.raises(TimeoutError, match="did not finish within 10"):
        spawn(_hangs, 2, device="cpu", timeout_s=10)
