"""CUDA kernels of the port against their plain PyTorch versions.

These tests need an NVIDIA card (marker ``cuda``) and skip without one;
whether a card is present is decided inside the fixture, never at
import.  The file imports no jax, so it also runs on a machine without
JAX — there, without the jax-configuring conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch import kernels
from buildingsegment_tpu_torch.core.morton import morton_argsort, morton_sort
from buildingsegment_tpu_torch.ops.adopt import (
    adopt_table,
    plane_adopt_reference,
)
from buildingsegment_tpu_torch.ops.compact_sweep import (
    COMPACT_L,
    compact_slot_stats,
    compact_sweep_reference,
)
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.knn import knn
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.pallas_knn import (
    _prepare,
    knn_exact_reference,
)
from buildingsegment_tpu_torch.ops.segsum import (
    payload_moment_sums_reference,
    plane_sums_reference,
    table_lookup_cols_reference,
    table_lookup_reference,
)
from buildingsegment_tpu_torch.ops.stats_mxu import (
    seed_sweep_mxu_reference,
    stats_mxu_reference,
)
from buildingsegment_tpu_torch.ops.stats_sweep import stats_sweep_reference
from buildingsegment_tpu_torch.ops.window_sweep import (
    label_sweep_reference,
    refine_sweep_reference,
    seed_sweep_reference,
)
from buildingsegment_tpu_torch.pipeline import (
    DEFAULT_CONFIG,
    HostPointCloud,
    PipelineConfig,
    segment_cloud,
)
from buildingsegment_tpu_torch.utils import bij_agreement, make_building_cloud

pytestmark = pytest.mark.cuda

TH, CTH, EDGE = 300.0, 0.88, 600.0
_SCENE = dict(seed=5, spacing_mm=120.0, width_mm=5000.0, depth_mm=4000.0,
              wall_h_mm=3000.0, ridge_h_mm=4000.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    kernels.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    pts, _ = make_building_cloud(**_SCENE)
    cap = 16384
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos).to(cuda),
                                 torch.from_numpy(mask).to(cuda), True)
    sposf = spos.float()
    _, _, nrm, _ = knn_normals_window_sorted(
        sposf, smask, 16, window=32, radius=300.0, max_nn=50
    )
    return sposf, nrm, smask


@pytest.mark.parametrize("signed,w", [(False, 16), (True, 8)])
def test_label_sweep_kernel_matches_plain(scene, signed, w):
    pos, nrm, mask = scene
    n = mask.shape[0]
    g = torch.Generator(device="cpu").manual_seed(3)
    rows = torch.arange(n, device=pos.device)
    label = (rows // 7 * 7).to(torch.int32)
    drop = torch.rand(n, generator=g).to(pos.device) < 0.2
    label = torch.where(drop | ~mask, n, label).to(torch.int32)
    src = label.clamp(max=n - 1).long()
    has = (label < n)[:, None]
    mn = torch.where(has, nrm[src], 0.0)
    jitter = torch.randn((n, 3), generator=g).to(pos.device) * 40.0
    mc = torch.where(has, pos[src] + jitter, 0.0)
    cols = lambda t: [t[:, d].contiguous() for d in range(3)]
    args = (cols(pos), cols(nrm), cols(mn), cols(mc), label, mask)
    kw = dict(w=w, th_thickness=TH, th_normal_cos=CTH, edge_gate2=EDGE ** 2,
              inf_label=n, signed=signed)
    before = kernels.launch_counts["label_sweep"]
    k_new, k_best = kernels.label_sweep_cuda(*args, **kw)
    assert kernels.launch_counts["label_sweep"] == before + 1
    p_new, p_best = label_sweep_reference(*args, **kw)
    assert (k_new != label).sum() > 100 and (k_best < n).sum() > 100
    assert torch.equal(k_new, p_new) and torch.equal(k_best, p_best)


def _label_args(pos, nrm, mask, seed):
    """label_sweep inputs on a scene: labels in groups of 7 rows, a fifth
    dropped, models from the label's row (its normal, a jittered copy of
    its position), so hops and merges both fire."""
    n = mask.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.arange(n, device=pos.device)
    label = (rows // 7 * 7).to(torch.int32)
    drop = torch.rand(n, generator=g).to(pos.device) < 0.2
    label = torch.where(drop | ~mask, n, label).to(torch.int32)
    src = label.clamp(max=n - 1).long()
    has = (label < n)[:, None]
    mn = torch.where(has, nrm[src], 0.0)
    jitter = torch.randn((n, 3), generator=g).to(pos.device) * 40.0
    mc = torch.where(has, pos[src] + jitter, 0.0)
    cols = lambda t: [t[:, d].contiguous() for d in range(3)]
    return (cols(pos), cols(nrm), cols(mn), cols(mc), label, mask)


def _tiled_scene(scene, n):
    """The scene repeated side by side (each copy 1e5 mm further in x)
    and cut to ``n`` rows: a Morton-sorted-like input of any size."""
    pos, nrm, mask = scene
    reps = -(-n // mask.shape[0])
    shift = torch.arange(reps, device=pos.device).repeat_interleave(
        mask.shape[0])[:, None] * torch.tensor([1e5, 0.0, 0.0],
                                               device=pos.device)
    return ((pos.repeat(reps, 1) + shift)[:n].contiguous(),
            nrm.repeat(reps, 1)[:n].contiguous(), mask.repeat(reps)[:n])


@pytest.mark.parametrize("case,w", [
    ("scene", 1), ("scene", 48), ("cut", 16), ("cut", 48),
    ("small", 16), ("small", 1), ("all_masked", 16),
    ("scene", kernels.LABEL_TILE_MAX_W), ("scene", kernels.LABEL_TILE_MAX_W + 1),
    ("rows_13952", 16), ("rows_73728", 16), ("rows_223232", 16),
])
def test_label_sweep_kernel_windows(scene, case, w):
    """#1 against its plain version, bit for bit: the tile at w = 1, 16
    (the path's window, the instance with w fixed) and 48, its widest
    window and one past it (the one-thread-a-row kernel); a row count not
    a multiple of the 64-row tile with a masked run across a tile edge
    ("cut"), fewer rows than a tile ("small"), no valid row, and the
    path's three sizes (the default path's deepest level, config 5's
    deepest level, the single-level path)."""
    pos, nrm, mask = scene
    if case == "cut":
        pos, nrm, mask = _cut_scene(scene)
    elif case == "small":
        pos, nrm, mask = pos[:50].contiguous(), nrm[:50].contiguous(), \
            mask[:50].clone()
        mask[:3] = False
    elif case == "all_masked":
        mask = torch.zeros_like(mask)
    elif case.startswith("rows_"):
        pos, nrm, mask = _tiled_scene(scene, int(case[5:]))
    args = _label_args(pos, nrm, mask, 5)
    kw = dict(w=w, th_thickness=TH, th_normal_cos=CTH, edge_gate2=EDGE ** 2,
              inf_label=mask.shape[0])
    before = kernels.launch_counts["label_sweep"]
    k_new, k_best = kernels.label_sweep_cuda(*args, **kw)
    assert kernels.launch_counts["label_sweep"] == before + 1
    p_new, p_best = label_sweep_reference(*args, **kw)
    assert torch.equal(k_new, p_new) and torch.equal(k_best, p_best)
    if case in ("all_masked",):
        assert torch.equal(k_new, args[4]) and (k_best == mask.shape[0]).all()
    elif case != "small" and w > 1:
        assert (k_new != args[4]).sum() > 100 and (k_best < mask.shape[0]).sum() > 50


# "scene": a fifth of the scene's rows live; "bound_B": exactly B live
# slots, one row each (the pair phase's 128-row and 32-column tile edges,
# one slot, lc); "coplanar": a flat grid whose 2,048 slots (random ids, 4
# rows each) all lie on one plane, so pairs merge across every row tile
_COMPACT_CASES = ("scene", "bound_1", "bound_127", "bound_128", "bound_129",
                  "bound_700", "bound_2048", "coplanar")


def _compact_problem(scene, case):
    """(pos, nrm, mask, clab, bound) of one case, slots numbered in row
    order (the grid's at random)."""
    pos, nrm, mask = scene
    n, lc, dev = mask.shape[0], COMPACT_L, pos.device
    g = torch.Generator(device="cpu").manual_seed(4)
    if case == "coplanar":
        k = torch.arange(4 * lc)
        pos = torch.stack([(k % 128) * 100.0, (k // 128) * 100.0,
                           torch.zeros(4 * lc)], 1).to(dev)
        nrm = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(4 * lc, 3)
        nrm = nrm.contiguous()
        mask = torch.ones(4 * lc, dtype=torch.bool, device=dev)
        slot = torch.randperm(lc, generator=g).repeat_interleave(4)
        return pos, nrm, mask, slot.to(torch.int32).to(dev), lc
    if case == "scene":
        live = mask & (torch.rand(n, generator=g).to(dev) < 0.2)
    else:
        rows = torch.nonzero(mask).flatten().cpu()
        pick = rows[torch.randperm(rows.shape[0], generator=g)]
        live = torch.zeros(n, dtype=torch.bool)
        live[pick[:int(case[6:])]] = True
        live = live.to(dev)
    clab = torch.where(live, torch.cumsum(live, 0) - 1, lc).to(torch.int32)
    return pos, nrm, mask, clab, int(live.sum())


@pytest.mark.parametrize("case", _COMPACT_CASES)
@pytest.mark.parametrize("anchor_gate", [True, False])
def test_compact_sweep_kernel_matches_plain(scene, anchor_gate, case):
    """Three chained sweeps from a singleton slot state: labels, counters
    and the per-slot sums of the stats phase (``stats_out``) equal at
    every step (the sums run in the same fixed order in both versions,
    the pair and jump phases are integer mins)."""
    pos, nrm, mask, clab, bound = _compact_problem(scene, case)
    w, lc = 16, COMPACT_L
    assert bound <= lc
    if case.startswith("bound_"):
        assert bound == int(case[6:])
    cn = canonicalize_normals(nrm)
    live = clab < lc
    anchor = torch.zeros((lc, 3), device=pos.device)
    anchor[clab[live].long()] = cn[live]
    thac = 0.95 if anchor_gate else 0.0
    kw = dict(lc=lc, w=w, th_thickness=TH, th_normal_cos=CTH,
              edge_gate2=EDGE ** 2, root_gate=EDGE, th_anchor_cos=thac,
              anchor_gate=anchor_gate)
    stats = torch.empty((lc, 16), dtype=torch.float32, device=pos.device)
    for step in range(3):
        args = (_cols(pos), _cols(nrm), _cols(cn), mask, clab, anchor, bound)
        k_lab, k_cnt = kernels.compact_sweep_cuda(*args, stats_out=stats,
                                                  **kw)
        p_lab, p_cnt = compact_sweep_reference(*args, **kw)
        want = compact_slot_stats(_cols(pos), _cols(cn), clab, anchor, bound,
                                  lc=lc, w=w, th_anchor_cos=thac,
                                  anchor_gate=anchor_gate)
        assert torch.equal(stats, want)
        assert torch.equal(k_lab, p_lab) and torch.equal(k_cnt, p_cnt)
        if step == 0 or case == "scene":
            assert int(k_cnt[0]) > 0
        if case == "coplanar" and step == 0:
            # the pair tests merged slots far apart in id
            assert int(k_cnt[1]) < lc - 128
        clab, bound = k_lab, min(int(k_cnt[1]) + 1, bound)


@pytest.mark.parametrize("w", [1, 48, 2048, 2049])
def test_compact_sweep_kernel_windows(scene, w):
    """#2 at other windows than the path's 16: the hop tile with w taken
    at run time (1, 48, its widest, 2,048) and the one-thread-a-row hop
    past it (2,049); labels, counters and per-slot sums equal the plain
    version's bit for bit."""
    pos, nrm, mask, clab, bound = _compact_problem(scene, "scene")
    lc = COMPACT_L
    cn = canonicalize_normals(nrm)
    live = clab < lc
    anchor = torch.zeros((lc, 3), device=pos.device)
    anchor[clab[live].long()] = cn[live]
    kw = dict(lc=lc, w=w, th_thickness=TH, th_normal_cos=CTH,
              edge_gate2=EDGE ** 2, root_gate=EDGE, th_anchor_cos=0.95,
              anchor_gate=True)
    args = (_cols(pos), _cols(nrm), _cols(cn), mask, clab, anchor, bound)
    stats = torch.empty((lc, 16), dtype=torch.float32, device=pos.device)
    k_lab, k_cnt = kernels.compact_sweep_cuda(*args, stats_out=stats, **kw)
    p_lab, p_cnt = compact_sweep_reference(*args, **kw)
    want = compact_slot_stats(_cols(pos), _cols(cn), clab, anchor, bound,
                              lc=lc, w=w, th_anchor_cos=0.95,
                              anchor_gate=True)
    assert torch.equal(stats, want)
    assert torch.equal(k_lab, p_lab) and torch.equal(k_cnt, p_cnt)
    assert int(k_cnt[0]) > 0


def test_kernel_wrappers_reject_bad_inputs(scene):
    pos, nrm, mask = scene
    n = mask.shape[0]
    c = [pos[:, 0].contiguous()] * 3
    label = torch.zeros(n, dtype=torch.int64, device=pos.device)
    with pytest.raises(ValueError):
        kernels.label_sweep_cuda(c, c, c, c, label, mask, w=16,
                                 th_thickness=TH, th_normal_cos=CTH,
                                 edge_gate2=1.0, inf_label=n)


_SLICE1 = ("label_sweep", "compact_sweep")
_PALLAS = ("knn_exact",)
_MULTIGRID = ("stats_sweep", "seed_sweep", "label_sweep", "refine_sweep",
              "payload_moment_sums", "table_lookup", "plane_adopt")
_MXU = ("stats_mxu", "seed_mxu") + _MULTIGRID[2:]


@pytest.mark.parametrize(
    "cfg,launched",
    [
        (PipelineConfig(knn_method="window", seg_group=1,
                        pad_to_multiple=2048), _SLICE1),
        (PipelineConfig(knn_method="window"), _MULTIGRID),
        (PipelineConfig(knn_method="window", stats_rank_mode="mxu",
                        seg_seed_mode="mxu"), _MXU),
        (PipelineConfig(knn_method="brute"), ()),
        (PipelineConfig(knn_method="pallas"), _PALLAS),
    ],
    ids=["single_level", "default_multigrid", "mxu", "brute", "pallas"],
)
def test_segment_cloud_card_matches_cpu(cuda, cfg, launched):
    pts, truth = make_building_cloud(**_SCENE)
    kernels.reset_launch_counts()
    a = segment_cloud(HostPointCloud(positions=pts), cfg, device="cuda")
    assert all(kernels.launch_counts[k] > 0 for k in launched), \
        kernels.launch_counts
    # the block-form and the exact stats/seed sweeps exclude each other
    for exact, block in (("stats_sweep", "stats_mxu"),
                         ("seed_sweep", "seed_mxu")):
        assert not (kernels.launch_counts[exact]
                    and kernels.launch_counts[block]), kernels.launch_counts
    b = segment_cloud(HostPointCloud(positions=pts), cfg, device="cpu")
    assert a.num_planes == b.num_planes
    assert bij_agreement(a.plane_idx, b.plane_idx) >= 0.99
    assert abs(bij_agreement(truth, a.plane_idx)
               - bij_agreement(truth, b.plane_idx)) < 0.01


def _cols(t):
    return tuple(t[:, d].contiguous() for d in range(3))


@pytest.mark.parametrize("radius,max_nn", [(300.0, 50), (100.0, 50),
                                           (1e6, None)])
def test_stats_sweep_kernel_matches_plain(scene, radius, max_nn):
    pos, _nrm, mask = scene
    kw = dict(k=15, w=48, radius=radius, max_nn=max_nn)
    got = kernels.stats_sweep_cuda(_cols(pos), mask, **kw)
    ref = stats_sweep_reference(_cols(pos), mask, **kw)
    assert (got[0] > 0).sum() > 1000
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# #3's hard cases (csrc/stats_sweep.cu, csrc/select_rank.cuh): every
# window width the kernel takes (the main path's 48, the default 64, the
# CPU tests' 32, one wider), k = 1, a cap wider than the window, a cap
# that binds, ranks past one selection pass of 16, rows with fewer valid
# candidates than r_k, tied distances, and n not a multiple of the
# kernel's 256-row blocks (the sparse cloud's 7,000 rows)
_STATS_CASES = {
    "w32": ("scene", dict(k=15, w=32, radius=100.0, max_nn=50)),
    "w64": ("scene", dict(k=15, w=64, radius=300.0, max_nn=50)),
    "w100_cap_binds": ("scene", dict(k=15, w=100, radius=600.0, max_nn=50)),
    "k1": ("scene", dict(k=1, w=48, radius=300.0, max_nn=50)),
    # estimate_normals_window's mode: no order statistic, no cap
    "radius_only_w64": ("scene", dict(k=1, w=64, radius=100.0,
                                      max_nn=None)),
    "cap_wider_than_window": ("scene", dict(k=15, w=48, radius=600.0,
                                            max_nn=100)),
    "cap_binds": ("scene", dict(k=15, w=48, radius=600.0, max_nn=50)),
    "deep_ranks": ("scene", dict(k=40, w=48, radius=600.0, max_nn=70)),
    "sparse": ("sparse", dict(k=30, w=48, radius=3000.0, max_nn=20)),
    "ties": ("ties", dict(k=15, w=48, radius=600.0, max_nn=50)),
}


@pytest.mark.parametrize("case", list(_STATS_CASES))
def test_stats_sweep_kernel_hard_cases(scene, case):
    """#3 against its plain version, bit for bit, on its hard cases."""
    data, kw = _STATS_CASES[case]
    if data == "sparse":
        pos, _nrm, mask, _dk = _sparse_cloud(scene[0].device)
    else:
        pos, _nrm, mask = scene
    if data == "ties":  # every row's position twice: tied distances
        pos = pos.clone()
        pos[1::2] = pos[0::2]
    got = kernels.stats_sweep_cuda(_cols(pos), mask, **kw)
    ref = stats_sweep_reference(_cols(pos), mask, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if kw["k"] == 1:
        assert not got[0].any()
    elif data == "sparse":  # some rows with fewer than k − 1 valid
        # candidates (30% of the rows are valid), some with more
        assert (got[0] > 0).sum() > 100
        assert ((got[0] == 0) & mask).sum() > 100
    else:
        assert (got[0] > 0).sum() > 1000
    if case in ("cap_binds", "w100_cap_binds"):
        assert (got[1] == kw["max_nn"]).sum() > 1000


def test_stats_sweep_rejects_unsupported_w(scene):
    pos, _nrm, mask = scene
    for w in (0, kernels.STATS_MAX_W + 1):
        with pytest.raises(ValueError):
            kernels.stats_sweep_cuda(_cols(pos), mask, k=15, w=w,
                                     radius=100.0, max_nn=50)


@pytest.mark.parametrize("signed", [False, True])
def test_seed_sweep_kernel_matches_plain(scene, signed):
    pos, nrm, mask = scene
    dk = stats_sweep_reference(_cols(pos), mask, k=15, w=48, radius=100.0,
                               max_nn=50)[0]
    kw = dict(w=16, th_thickness=TH, th_normal_cos=CTH, signed=signed)
    got = kernels.seed_sweep_cuda(_cols(pos), _cols(nrm), mask, dk, **kw)
    ref = seed_sweep_reference(_cols(pos), _cols(nrm), mask, dk, **kw)
    assert got.sum() > 100 and (mask & ~got).sum() > 100
    assert torch.equal(got, ref)


def _cut_scene(scene):
    """The scene cut to 16,284 rows (not a multiple of either tile of #4
    and #6) with a masked run across the tile edge at row 4,096."""
    pos, nrm, mask = scene
    n = 16284
    mask = mask[:n].clone()
    mask[4096 - 40:4096 + 30] = False
    return pos[:n].contiguous(), nrm[:n].contiguous(), mask


@pytest.mark.parametrize("case,w", [
    ("scene", 1), ("scene", 48), ("cut", 48), ("sparse", 48),
    ("scene", kernels.SEED_TILE_MAX_W + 1),
])
def test_seed_sweep_kernel_windows(scene, case, w):
    """#4 against its plain version, bit for bit, at the path's w = 48,
    at w = 1, past the tile's widest window (the per-row kernel), on a
    row count that is not a multiple of the tile and on the sparse
    cloud."""
    if case == "sparse":
        pos, nrm, mask, dk = _sparse_cloud(scene[0].device)
    else:
        pos, nrm, mask = _cut_scene(scene) if case == "cut" else scene
        dk = stats_sweep_reference(_cols(pos), mask, k=15, w=48,
                                   radius=100.0, max_nn=50)[0]
    kw = dict(w=w, th_thickness=TH, th_normal_cos=CTH)
    before = kernels.launch_counts["seed_sweep"]
    got = kernels.seed_sweep_cuda(_cols(pos), _cols(nrm), mask, dk, **kw)
    assert kernels.launch_counts["seed_sweep"] == before + 1
    ref = seed_sweep_reference(_cols(pos), _cols(nrm), mask, dk, **kw)
    assert got.sum() > 30 and (mask & ~got).sum() > 30
    assert torch.equal(got, ref)


def _sparse_cloud(cuda):
    """A cloud at building span (unsorted), 7,000 rows (not a multiple of
    the 128-row blocks), 30% valid, rows 1,024–1,919 (seven whole blocks)
    and the last 300 rows masked; random unit normals and seed balls."""
    rng = np.random.default_rng(21)
    n = 7000
    pos = rng.integers(0, 9000, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.3
    mask[1024:1920] = False
    mask[-300:] = False
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dk = rng.uniform(1e5, 4e7, n).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    return T(pos), T(nrm), T(mask), T(dk)


@pytest.mark.parametrize("case,k,w,radius,max_nn", [
    ("scene", 15, 48, 100.0, 50), ("scene", 15, 48, 300.0, 50),
    ("scene", 15, 48, 1e6, None), ("sparse", 15, 48, 3000.0, 20),
    # w = 16; no cap; dk past the 2w window values (0); later selection
    # passes for both ranks
    ("scene", 15, 16, 300.0, 20), ("scene", 15, 48, 300.0, None),
    ("scene", 101, 48, 300.0, 50), ("scene", 40, 48, 300.0, 80),
    ("sparse", 5, 16, 3000.0, None),
    # the cap binds on every row: a warp each (2w <= 128), or further
    # passes and a second fold in the query's thread (2w > 128)
    ("scene", 15, 48, 1e6, 50), ("scene", 15, 64, 1e6, 50),
    ("scene", 15, 65, 1e6, 50), ("scene", 40, 100, 1e6, 150),
    # every coordinate above the origin's 3e7 fill
    ("far", 15, 16, 300.0, 20),
])
def test_stats_mxu_kernel_matches_plain(scene, case, k, w, radius, max_nn):
    """#15 against its plain version, bit for bit, on the card and on the
    CPU: the building scene (Morton-sorted, padded), the scene moved 1e8
    along each axis (blocks whose candidates are all valid take the least
    coordinate as their origin, not the 3e7 fill), and the sparse cloud
    with masked rows and empty blocks."""
    if case == "scene":
        pos, _nrm, mask = scene
    elif case == "far":
        pos, _nrm, mask = scene
        pos = pos + 1e8
    else:
        pos, _nrm, mask, _dk = _sparse_cloud(scene[0].device)
    kw = dict(k=k, w=w, radius=radius, max_nn=max_nn)
    before = kernels.launch_counts["stats_mxu"]
    got = kernels.stats_mxu_cuda(_cols(pos), mask, **kw)
    assert kernels.launch_counts["stats_mxu"] == before + 1
    ref = stats_mxu_reference(_cols(pos), mask, **kw)
    on_cpu = stats_mxu_reference(_cols(pos.cpu()), mask.cpu(), **kw)
    if k - 1 > 2 * w:
        assert not got[0].any()
    else:
        assert (got[0] > 0).sum() > 1000
    assert (got[1] > 1).sum() > 1000
    for g, r, c in zip(got, ref, on_cpu):
        assert torch.equal(g, r) and torch.equal(g.cpu(), c)


def test_stats_mxu_kernel_limits(scene):
    """#15's named limits: w = ``STATS_MXU_MAX_W`` and a radius² just
    below ``STATS_MXU_MAX_R2`` (every valid window slot inside it) equal
    the plain version bit for bit; one past either, k = 0 or max_nn = 0
    raises."""
    pos, _nrm, mask = scene
    pos, mask = pos[:2048], mask[:2048]
    for w, radius in ((kernels.STATS_MXU_MAX_W, 300.0), (48, 3.16e14)):
        kw = dict(k=15, w=w, radius=radius, max_nn=50)
        got = kernels.stats_mxu_cuda(_cols(pos), mask, **kw)
        ref = stats_mxu_reference(_cols(pos), mask, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    bad = (dict(w=kernels.STATS_MXU_MAX_W + 1), dict(radius=3.17e14),
           dict(k=0), dict(max_nn=0))
    for change in bad:
        kw = dict(k=15, w=48, radius=300.0, max_nn=50) | change
        with pytest.raises(ValueError, match="stats_mxu"):
            kernels.stats_mxu_cuda(_cols(pos), mask, **kw)


# balls that take the full walk: the 1e29 cut itself, above it, +inf
# and NaN, beside negative ones, on every sixth row
_FULL_WALK_BALLS = (float(np.float32(1e29)), 5e29, 2e30, float("inf"),
                    float("nan"), -1.0)


@pytest.mark.parametrize("case,signed,w", [
    ("scene", False, 16), ("scene", True, 16), ("sparse", False, 16),
    ("scene", False, 1), ("scene", False, 48), ("scene", True, 100),
    ("full_walk", False, 16), ("full_walk", True, 48), ("huge", False, 16),
])
def test_seed_mxu_kernel_matches_plain(scene, case, signed, w):
    """#16 against its plain version, bit for bit, on the card and on the
    CPU: the building scene with its block-form seed balls at w = 1, 16,
    48 and 100; the sparse cloud with random normals and balls; the scene
    with balls at or above 1e29, +inf and NaN mixed in (the full walk);
    the scene 1e12 times larger, its balls 1e24 times and the band 1e12
    times (staged |c−o|² above the window walk's limit: the blocks' full
    walk)."""
    if case == "sparse":
        pos, nrm, mask, dk = _sparse_cloud(scene[0].device)
    else:
        pos, nrm, mask = scene
        dk = stats_mxu_reference(_cols(pos), mask, k=15, w=48, radius=100.0,
                                 max_nn=50)[0]
    if case == "full_walk":
        balls = torch.tensor(_FULL_WALK_BALLS, device=dk.device)
        rows = torch.arange(dk.shape[0], device=dk.device)
        pick = rows % 6 == 0
        dk = torch.where(pick, balls[(rows // 6) % len(balls)], dk)
    th = TH
    if case == "huge":
        pos, dk, th = pos * 1e12, dk * 1e24, TH * 1e12
    kw = dict(w=w, th_thickness=th, th_normal_cos=CTH, signed=signed)
    before = kernels.launch_counts["seed_mxu"]
    got = kernels.seed_mxu_cuda(_cols(pos), _cols(nrm), mask, dk, **kw)
    assert kernels.launch_counts["seed_mxu"] == before + 1
    ref = seed_sweep_mxu_reference(_cols(pos), _cols(nrm), mask, dk, **kw)
    on_cpu = seed_sweep_mxu_reference(_cols(pos.cpu()), _cols(nrm.cpu()),
                                      mask.cpu(), dk.cpu(), **kw)
    assert got.sum() > 30 and (mask & ~got).sum() > (100 if w > 1 else 10)
    assert torch.equal(got, ref) and torch.equal(got.cpu(), on_cpu)


@pytest.mark.parametrize("cols", [1, 3, 8])
def test_table_lookup_cols_kernel_matches_plain(cuda, cols):
    """#10 against its plain version, bit for bit, on the card and on the
    CPU: ids below 0, inside and above the live bound and above the
    table, 50,001 rows, a table holding −0.0 (read back as +0.0)."""
    g = torch.Generator(device="cpu").manual_seed(30 + cols)
    n = 50_001
    ids = torch.randint(-3, 700, (n,), generator=g, dtype=torch.int32)
    lut = torch.randn((600, cols), generator=g)
    lut[5] = -0.0
    for n_live in (0, 1, 130, 600, 5000):
        before = kernels.launch_counts["table_lookup_cols"]
        got = kernels.table_lookup_cols_cuda(ids.to(cuda), lut.to(cuda),
                                             n_live)
        assert kernels.launch_counts["table_lookup_cols"] == before + 1
        on_card = table_lookup_cols_reference(ids.to(cuda), lut.to(cuda),
                                              n_live)
        on_cpu = table_lookup_cols_reference(ids, lut, n_live)
        assert got.shape == (cols, n)
        assert torch.equal(got, on_card) and torch.equal(got.cpu(), on_cpu)
    assert not torch.signbit(got[:, ids.to(cuda) == 5]).any()


def _plane_problem(pos, nrm, mask, seed, *, run=300, top=9, p=64):
    """Plane ids by row blocks of ``run`` rows, ids 1..``top`` (some
    dropped), and their fitted table: row id − 1 for ids 1..p − 1."""
    n = mask.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.arange(n, device=pos.device)
    pid = (rows // run % top + 1).to(torch.int32)
    drop = torch.rand(n, generator=g).to(pos.device) < 0.3
    pid = torch.where(drop | ~mask, 0, pid).to(torch.int32)
    cnt = torch.zeros(p, device=pos.device).index_add_(
        0, pid.long(), torch.ones(n, device=pos.device))
    sn = torch.zeros((p, 3), device=pos.device).index_add_(
        0, pid.long(), canonicalize_normals(nrm))
    sc = torch.zeros((p, 3), device=pos.device).index_add_(0, pid.long(), pos)
    pn = sn[1:] / sn[1:].norm(dim=1, keepdim=True).clamp_min(1e-9)
    pc = sc[1:] / cnt[1:, None].clamp_min(1.0)
    pn = torch.nan_to_num(pn)
    table = torch.stack([pn[:, 0], pn[:, 1], pn[:, 2],
                         (pn * pc).sum(1)], 1).contiguous()
    return pid, table, pc.contiguous()


@pytest.mark.parametrize("clean", [True, False])
def test_refine_sweep_kernel_matches_plain(scene, clean):
    pos, nrm, mask = scene
    pid, table, _ = _plane_problem(pos, nrm, mask, 5)
    kw = dict(w=16, th_thickness=TH, th_normal_cos=CTH, edge_gate2=EDGE ** 2,
              clean=clean, adopt=True)
    args = (_cols(pos), _cols(nrm), mask, pid, table, 9)
    got = kernels.refine_sweep_cuda(*args, **kw)
    ref = refine_sweep_reference(*args, **kw)
    assert (got != pid).sum() > 100
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", [
    "w48", "w1", "cut", "tiles", "ntab0", "ntab4096", "ntab4224", "wide_w",
    "sparse",
])
def test_refine_sweep_kernel_cases(scene, case):
    """#6 against its plain version, bit for bit: at w = 48 and w = 1 (the
    path's w = 16 is the test above); on a row count that is not a
    multiple of the tile; a tile with no hole row beside one with only
    hole rows; an empty live table (ntab = 0), a full 4,096-row one (64
    KB) and one above it; past the tile's widest window (the per-row
    kernel, its 4,096-row table in 64 KB of shared memory); the sparse
    cloud with wide gates."""
    w, clean, n_live = 48, True, 9
    th, cth, eg2 = TH, CTH, EDGE ** 2
    if case == "sparse":
        pos, nrm, mask, _dk = _sparse_cloud(scene[0].device)
        th, cth, eg2 = 2000.0, 0.3, 2500.0 ** 2
    elif case == "cut":
        pos, nrm, mask = _cut_scene(scene)
    else:
        pos, nrm, mask = scene
    prob = {}
    if case in ("ntab4096", "ntab4224", "wide_w"):
        rows = 4224 if case == "ntab4224" else 4096
        prob = dict(run=4, top=rows, p=rows + 1)  # table rows: ids 1..p-1
        n_live = rows
    pid, table, _ = _plane_problem(pos, nrm, mask, 7, **prob)
    if case == "w1":
        w = 1
    elif case == "wide_w":
        w = kernels.REFINE_TILE_MAX_W + 1
    elif case == "ntab0":  # no live table: rows keep their ids, none adopts
        n_live, clean = 0, False
    elif case == "tiles":
        # tile 24 keeps every row's id (none dropped), tile 25 is all holes
        rows = kernels.REFINE_TILE_ROWS
        full, holes = slice(24 * rows, 25 * rows), slice(25 * rows, 26 * rows)
        assert mask[full].all() and mask[holes].all()
        pid = pid.clone()
        pid[full] = (torch.arange(24 * rows, 25 * rows, device=pid.device)
                     // 300 % 9 + 1).to(torch.int32)
        pid[holes] = 0
        clean = False
    kw = dict(w=w, th_thickness=th, th_normal_cos=cth, edge_gate2=eg2,
              clean=clean, adopt=True)
    args = (_cols(pos), _cols(nrm), mask, pid, table, n_live)
    before = kernels.launch_counts["refine_sweep"]
    got = kernels.refine_sweep_cuda(*args, **kw)
    assert kernels.launch_counts["refine_sweep"] == before + 1
    ref = refine_sweep_reference(*args, **kw)
    assert torch.equal(got, ref)
    adopted = ((pid == 0) & mask & (ref > 0)).sum()
    if case == "ntab0":
        assert adopted == 0 and torch.equal(got, torch.where(mask, pid, 0))
    elif case != "w1":
        assert adopted > 20
    if case == "tiles":
        rows = kernels.REFINE_TILE_ROWS
        assert torch.equal(got[full], pid[full]) and (got[holes] > 0).any()


def test_payload_moment_sums_kernel_matches_plain(scene):
    pos, nrm, mask = scene
    pid, _table, pc = _plane_problem(pos, nrm, mask, 6)
    n = mask.shape[0]
    ids = torch.where(pid > 0, pid - 1, 4096).to(torch.int32)
    sq = (pos * pos).sum(1, keepdim=True)
    payload = torch.cat([torch.ones((n, 1), device=pos.device),
                         canonicalize_normals(nrm), pos, sq], 1).contiguous()
    got = kernels.payload_moment_sums_cuda(ids, payload, pc, 9,
                                           table_cap=4096)
    ref = payload_moment_sums_reference(ids, payload, pc, 9, table_cap=4096)
    assert int(got[0][:, 0].sum()) == int((pid > 0).sum())
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kernel", ["payload_moment_sums", "plane_adopt"])
def test_block_sums_continue_from_init(scene, kernel):
    """#11 and #13 with ``init`` (a shard continuing the shards before
    it): the rows cut at a block boundary, the second part started from
    the first part's tables, equal the whole rows' sums bit for bit, on
    the card and in the plain version."""
    pos, nrm, mask = scene
    n = mask.shape[0]
    payload = torch.cat([torch.ones((n, 1), device=pos.device),
                         canonicalize_normals(nrm), pos,
                         (pos * pos).sum(1, keepdim=True)], 1).contiguous()
    if kernel == "payload_moment_sums":
        pid, _table, pc = _plane_problem(pos, nrm, mask, 6)
        ids = torch.where(pid > 0, pid - 1, 4096).to(torch.int32)
        cut = 8 * kernels.PAYMOM_ROWS

        def run(fn, rows, init=None):
            return fn(ids[rows], payload[rows], pc, 9, table_cap=4096,
                      init=init)

        fns = (kernels.payload_moment_sums_cuda,
               payload_moment_sums_reference)
    else:
        rng = np.random.default_rng(5)
        k = 96
        idx = torch.from_numpy(rng.integers(0, n, k)).to(pos.device)
        nk = canonicalize_normals(nrm)[idx]
        ck = pos[idx]
        table = adopt_table(nk, ck, (nk * ck).sum(1), (ck * ck).sum(1),
                            torch.full((k,), 4000.0 ** 2, device=pos.device),
                            torch.ones(k, dtype=torch.bool, device=pos.device))
        lanes = torch.arange(128, dtype=torch.int32, device=pos.device)
        holes = mask & torch.from_numpy(rng.uniform(size=n) < 0.5).to(
            pos.device)
        cut = 32 * kernels.ADOPT_ROWS

        def run(fn, rows, init=None):
            return fn(payload[rows], holes[rows], table, lanes,
                      th_thickness=TH, th_cos=CTH, init=init)[2]

        fns = (kernels.plane_adopt_cuda, plane_adopt_reference)
    def tables(out):
        return out if isinstance(out, tuple) else (out,)

    head, tail = slice(0, cut), slice(cut, n)
    parts = []
    for fn in fns:
        whole = tables(run(fn, slice(0, n)))
        parts.append(tables(run(fn, tail, run(fn, head))))
        assert float(whole[0][:, 0].sum()) > 1000
        for w_, p_ in zip(whole, parts[-1]):
            assert torch.equal(w_, p_)
    for k_, p_ in zip(*parts):  # kernel ≡ plain version, with init
        assert torch.equal(k_, p_)


def test_table_lookup_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(8)
    ids = torch.randint(-3, 700, (50_000,), generator=g, dtype=torch.int32)
    lut = torch.randint(0, 500, (600,), generator=g, dtype=torch.int32)
    for n_live in (130, 600, 5000):
        got = kernels.table_lookup_cuda(ids.to(cuda), lut.to(cuda), n_live)
        ref = table_lookup_reference(ids, lut, n_live)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("cols", [1, 2, 3, 8, 17, 128])
def test_plane_sums_kernel_matches_plain(cuda, cols):
    """#8 against its plain version, on the card and on the CPU, bit for
    bit: ids over a 300-row table with dead ones (negative, above the
    live bound), 50,000 rows (not a multiple of the 1,024-row blocks);
    payloads of 1–2 columns (one staged round) and wider ones (folded 16
    columns at a time over the same sorted rows: 17 and 128 take two and
    eight rounds)."""
    g = torch.Generator(device="cpu").manual_seed(cols)
    n = 50_000
    ids = torch.randint(-3, 302, (n,), generator=g, dtype=torch.int32)
    pay = torch.rand((n, cols), generator=g) * 100.0
    pay[:, 0] = 1.0
    for n_live in (0, 1, 130, 300):
        before = kernels.launch_counts["plane_sums"]
        got = kernels.plane_sums_cuda(ids.to(cuda), pay.to(cuda), n_live,
                                      table_cap=300)
        assert kernels.launch_counts["plane_sums"] == before + (n_live > 0)
        on_card = plane_sums_reference(ids.to(cuda), pay.to(cuda), n_live,
                                       table_cap=300)
        on_cpu = plane_sums_reference(ids, pay, n_live, table_cap=300)
        assert got.shape == (384, cols)
        assert torch.equal(got, on_card) and torch.equal(got.cpu(), on_cpu)


@pytest.mark.parametrize("cols", [1, 3])
def test_plane_sums_kernel_matches_plain_dense(cuda, cols):
    """#8 on a dense histogram: 12 ids, so each holds some 85 rows of
    every 1,024-row block, and float payloads whose sum depends on the
    order, bit for bit against the plain version on the card and on the
    CPU (one column is where the card's accumulating ``index_put_`` would
    sum a run of equal ids out of row order)."""
    g = torch.Generator(device="cpu").manual_seed(10 + cols)
    n = 40_000
    ids = torch.randint(0, 12, (n,), generator=g, dtype=torch.int32)
    pay = torch.rand((n, cols), generator=g) * 1000.0 - 500.0
    got = kernels.plane_sums_cuda(ids.to(cuda), pay.to(cuda), 12,
                                  table_cap=12)
    on_card = plane_sums_reference(ids.to(cuda), pay.to(cuda), 12,
                                   table_cap=12)
    on_cpu = plane_sums_reference(ids, pay, 12, table_cap=12)
    assert got.shape == (128, cols)
    assert torch.equal(got, on_card) and torch.equal(got.cpu(), on_cpu)


def test_plane_sums_kernel_id_limit(cuda):
    """#8 at the stage-then-fold id limit: the largest live bound below
    ``FOLD_ID_LIMIT`` (2^21 − 128) equals the plain version bit for bit,
    its top ids included; a bound of 2^21 raises."""
    g = torch.Generator(device="cpu").manual_seed(7)
    top = kernels.FOLD_ID_LIMIT // 128 * 128
    n = 3000
    ids = torch.randint(top - 300, top + 50, (n,), generator=g,
                        dtype=torch.int32)
    ids[::97] = -1
    pay = (torch.rand((n, 1), generator=g) * 1000.0 - 500.0).to(cuda)
    ids = ids.to(cuda)
    got = kernels.plane_sums_cuda(ids, pay, top, table_cap=top)
    ref = plane_sums_reference(ids, pay, top, table_cap=top)
    assert got[top - 1, 0] != 0
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="live bound"):
        kernels.plane_sums_cuda(ids, pay, top + 1, table_cap=top + 1)


@pytest.mark.parametrize("payload", ["ones", "float"])
def test_plane_sums_kernel_config5_histogram(cuda, payload):
    """#8 at the shape of config 5's ground histogram: 1,179,648 rows,
    one column, 12 z bins (bound 128), masked rows on bin 12; a ones
    column as the raster sums, and a float one whose sums depend on the
    order.  Equal to the plain version bit for bit."""
    rng = np.random.default_rng(61)
    n, bins = 1_179_648, 12
    ids = np.clip(rng.normal(3.0, 2.5, n), 0, bins - 1).astype(np.int32)
    ids[rng.random(n) < 0.08] = bins
    pay = (np.ones((n, 1), np.float32) if payload == "ones"
           else rng.uniform(0, 3000, (n, 1)).astype(np.float32))
    ids_t, pay_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(pay).to(cuda)
    got = kernels.plane_sums_cuda(ids_t, pay_t, bins, table_cap=bins)
    ref = plane_sums_reference(ids_t, pay_t, bins, table_cap=bins)
    assert got.shape == (128, 1) and int((got[:, 0] > 0).sum()) == bins + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("signed", [False, True])
def test_plane_adopt_kernel_matches_plain(cuda, signed):
    rng = np.random.default_rng(3)
    n, k = 20_000, 96
    nk = rng.normal(size=(k, 3)).astype(np.float32)
    nk /= np.linalg.norm(nk, axis=1, keepdims=True)
    ck = rng.uniform(0, 30_000, size=(k, 3)).astype(np.float32)
    t = rng.integers(0, k, size=n)
    along = rng.normal(size=(n, 3)).astype(np.float32) * 800
    pos = ck[t] + along - np.sum(along * nk[t], 1, keepdims=True) * nk[t]
    pos = (pos + rng.normal(size=n)[:, None] * 250 * nk[t]).astype(np.float32)
    cn = nk[t] + rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    cn /= np.linalg.norm(cn, axis=1, keepdims=True)
    holes = rng.uniform(size=n) < 0.6
    holes[5000:9000] = False  # whole blocks without holes
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    pos_t, nk_t, ck_t = T(pos), T(nk), T(ck)
    payload = torch.cat([torch.ones((n, 1), device=cuda), T(cn), pos_t,
                         (pos_t * pos_t).sum(1, keepdim=True)], 1)
    reach2 = T(rng.uniform(500, 4000, size=k).astype(np.float32) ** 2)
    table = adopt_table(nk_t, ck_t, (nk_t * ck_t).sum(1),
                        (ck_t * ck_t).sum(1), reach2,
                        T(rng.uniform(size=k) < 0.8))
    rows = T(rng.permutation(1024)[:128].astype(np.int32))
    kw = dict(th_thickness=TH, th_cos=CTH, signed=signed)
    got = kernels.plane_adopt_cuda(payload, T(holes), table, rows, **kw)
    ref = plane_adopt_reference(payload, T(holes), table, rows, **kw)
    assert got[0].sum() > 1000
    for g_, r in zip(got, ref):
        assert torch.equal(g_, r)


def _adopt_problem(case, n, rng, device):
    """A hole-adoption problem whose lanes are known: 128 planes z = 0,
    3 m apart along x, reach 1 m; a hole row on plane l adopts lane l, a
    hole row between two planes adopts nothing.  Returns (payload, holes,
    table, rows, lane of each row or −1) with numpy's lanes."""
    k = kernels.ADOPT_LANES
    nblk = -(-n // kernels.ADOPT_ROWS)
    lanes = np.where(rng.random(n) < 0.5, rng.integers(0, k, n), -1)
    holes = np.repeat(rng.random(nblk) < 0.3, kernels.ADOPT_ROWS)[:n]
    holes &= rng.random(n) < 0.7
    if case == "distinct_lanes":  # block 3: 128 distinct lanes, shuffled
        blk = slice(3 * kernels.ADOPT_ROWS, 4 * kernels.ADOPT_ROWS)
        lanes[blk] = np.concatenate([rng.permutation(k)] * 2)
        holes[blk] = True
    # lane 7 fed by the first row of every block
    lanes[::kernels.ADOPT_ROWS] = 7
    holes[::kernels.ADOPT_ROWS] = True
    # blocks 5 and 6: holes, none adopted
    blk = slice(5 * kernels.ADOPT_ROWS, 7 * kernels.ADOPT_ROWS)
    lanes[blk] = -1
    holes[blk] = True
    cx = np.arange(k, dtype=np.float32) * 3000
    x = np.where(lanes >= 0, cx[np.maximum(lanes, 0)],
                 cx[rng.integers(0, k - 1, n)] + 1500)
    pos = np.stack([x + rng.uniform(-300, 300, n), rng.uniform(-300, 300, n),
                    rng.uniform(-50, 50, n)], 1).astype(np.float32)
    nrm = np.array([0, 0, 1]) + rng.normal(size=(n, 3)) * 0.05
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    payload = np.concatenate([np.ones((n, 1), np.float32), nrm, pos,
                              (pos * pos).sum(1, keepdims=True)], 1)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    nk = T(np.tile(np.float32([0, 0, 1]), (k, 1)))
    ck = T(np.stack([cx, np.zeros(k), np.zeros(k)], 1).astype(np.float32))
    table = adopt_table(nk, ck, torch.zeros(k, device=device),
                        (ck * ck).sum(1), torch.full((k,), 1e6, device=device),
                        torch.ones(k, dtype=torch.bool, device=device))
    rows = T(rng.permutation(4096)[:k].astype(np.int32))
    return T(payload.astype(np.float32)), T(holes), table, rows, lanes


@pytest.mark.parametrize("case,n", [("distinct_lanes", 20_000),
                                    ("config5_rows", 1_179_648)])
def test_plane_adopt_fold_matches_plain(cuda, case, n):
    """#13 on its stage-then-fold hard cases, at 20,000 rows and at config
    5's 1,179,648 (4,608 blocks): one block adopting into 128 distinct
    lanes, one lane fed by every block, blocks with holes and no adopted
    row; outputs and per-lane sums equal the plain version's bit for
    bit."""
    rng = np.random.default_rng(47)
    payload, holes, table, rows, lanes = _adopt_problem(case, n, rng, cuda)
    kw = dict(th_thickness=TH, th_cos=CTH)
    got = kernels.plane_adopt_cuda(payload, holes, table, rows, **kw)
    ref = plane_adopt_reference(payload, holes, table, rows, **kw)
    for g_, r in zip(got, ref):
        assert torch.equal(g_, r)
    want = torch.from_numpy((lanes >= 0) & holes.cpu().numpy())
    assert torch.equal(got[0].cpu(), want)
    nblk = -(-n // kernels.ADOPT_ROWS)
    assert int(got[2][7, 0]) >= nblk - 2  # blocks 5 and 6 adopt nothing
    if case == "distinct_lanes":
        assert int((got[2][:, 0] > 0).sum()) == kernels.ADOPT_LANES


def _knn_cloud(case, device):
    """(positions int32[C, 3], mask bool[C]) on ``device``: a random
    cloud, the small scene, an integer grid, a random cloud whose row
    count halves both tiles or one over the 20-bit range with
    near-duplicates, Morton-sorted, or an unsorted cloud whose last third
    is padding."""
    rng = np.random.default_rng(12)
    if case == "random":
        pts, cap = rng.integers(0, 20_000, (8000, 3)), 8192
    elif case == "scene":
        pts, cap = make_building_cloud(**_SCENE)[0], 9216
    elif case == "grid":  # extent 14: many equal d², ties by index
        pts, cap = rng.integers(0, 14, (8000, 3)), 8192
    elif case == "halved":  # 9,152 = 64 × 143: both tiles halved to 64
        pts, cap = rng.integers(0, 20_000, (9000, 3)), 9152
    elif case == "wide":  # the 20-bit range: d² far past 2^24 rounds
        pts, cap = rng.integers(0, 2**20, (8000, 3)), 8192
        near = rng.random(8000) < 0.2
        pts[near] = np.clip(pts[rng.integers(0, 8000, int(near.sum()))]
                            + rng.integers(-3, 4, (int(near.sum()), 3)),
                            0, 2**20 - 1)
    else:
        pts, cap = rng.integers(0, 3000, (2000, 3)), 3072
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    pos, mask = torch.from_numpy(pos).to(device), torch.from_numpy(mask).to(device)
    if case != "padding":
        order = morton_argsort(pos, mask)
        pos, mask = pos[order], mask[order]
    return pos, mask


@pytest.mark.parametrize("case,k", [
    ("random", 16), ("scene", 16), ("scene", 50), ("padding", 16),
    ("grid", 16), ("grid", 50), ("halved", 16), ("random", 2),
    ("wide", 16), ("wide", 50),
    ("scene", kernels.KNN_TILE_MAX_KK + 1), ("scene", kernels.KNN_TILE_MAX_KK + 2),
])
def test_knn_exact_kernel_matches_plain(cuda, case, k):
    """#14 against its plain version, bit for bit: the warp design up to
    k = KNN_TILE_MAX_KK + 1, the first design's kernel past it; ties on
    the integer grid; a row count whose query tile was halved to 64; rows
    over the 20-bit range with near-duplicates, whose d² lie far past
    2^24, where the filter's FMA form and the plain d² round apart."""
    pos, mask = _knn_cloud(case, cuda)
    cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct, w = _prepare(
        pos, mask, k)
    assert qt % kernels.KNN_TILE_QUERIES == 0 and ct % 32 == 0
    if case == "halved":
        assert (qt, ct) == (64, 64)
    args = (cols, seed_d, seed_i, visit, visit_d2, counts)
    kw = dict(qt=qt, ct=ct, w_excl=w)
    before = kernels.launch_counts["knn_exact"]
    got = kernels.knn_exact_cuda(*args, **kw)
    assert kernels.launch_counts["knn_exact"] == before + 1
    ref = knn_exact_reference(*args, **kw)
    # the scan replaced seeds somewhere, so the check is not vacuous
    assert (torch.sort(got[1], 1).values != torch.sort(seed_i, 1).values).any()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_brute_knn_ignores_tf32(cuda):
    """The brute kNN writes its cross term out, so a caller that turns
    TF32 matmuls on gets the same graph (with a TF32 matmul the error on
    q·c at |q|² ~ 1e7 mm² would exceed a neighbour's d²)."""
    pos, mask = _knn_cloud("scene", cuda)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        ref = knn(pos, mask, 50)
        torch.set_float32_matmul_precision("high")
        got = knn(pos, mask, 50)
    finally:
        torch.set_float32_matmul_precision(prev)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# The stage-then-fold sums (csrc/block_fold.cuh: #2's stats phase, #11):
# block b of 1024 rows covers rows [b·1024 − w, (b+1)·1024 − w), w = 0 for
# #11.  Each case is one of the kernels' hard shapes; n = 7000 is not a
# multiple of 1024.
_FOLD_CASES = ("one_id_block", "full_table", "run_edges", "dead_rows")


def _fold_ids(case, n, bound, w, dead, rng):
    """int32[n] row ids for one case; ``dead`` holds ids that do not
    count (below 0, at or above the bound, "no label")."""
    ids = np.repeat(rng.integers(0, bound, n // 40 + 1), 40)[:n]
    if case == "one_id_block":  # the longest fold: one id over a block
        ids[1024 - w:2048 - w] = 5
    elif case == "full_table":  # one block touching 1024 ids, bound − 1 too
        ids[2048 - w:3072 - w] = rng.permutation(bound)[:1024]
        ids[2048 - w] = bound - 1
    elif case == "run_edges":  # runs across every block edge (block 0's
        # edge sits at 1024 − w)
        for edge in range(1024 - w, n, 1024):
            ids[edge - 37:edge + 41] = rng.integers(0, bound)
    else:  # dead rows scattered, and one block with no live row
        pick = rng.random(n) < 0.2
        ids[pick] = rng.choice(dead, int(pick.sum()))
        ids[3072 - w:4096 - w] = dead[0]
    return ids.astype(np.int32)


def _unit_rows(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("case", _FOLD_CASES)
def test_compact_stats_fold_matches_plain(cuda, case):
    """#2 on the stage-then-fold hard cases: the per-slot sums of its
    stats phase (``stats_out``), the labels and the counters equal the
    plain version's bit for bit."""
    rng = np.random.default_rng(41)
    n, w, lc = 7000, 16, COMPACT_L
    bound = lc if case == "full_table" else 1500
    dead = np.array([lc] if bound == lc else [lc, bound + 3])
    clab = torch.from_numpy(_fold_ids(case, n, bound, w, dead, rng)).to(cuda)
    pos = torch.from_numpy(rng.uniform(0, 3e4, (n, 3)).astype(np.float32))
    nrm = torch.from_numpy(_unit_rows(rng, n))
    pos, nrm = pos.to(cuda), nrm.to(cuda)
    cn = canonicalize_normals(nrm)
    mask = torch.from_numpy(rng.random(n) < 0.95).to(cuda)
    anchor = torch.from_numpy(_unit_rows(rng, lc)).to(cuda)
    kw = dict(lc=lc, w=w, th_thickness=TH, th_normal_cos=CTH,
              edge_gate2=EDGE ** 2, root_gate=EDGE, th_anchor_cos=0.3,
              anchor_gate=True)
    args = (_cols(pos), _cols(nrm), _cols(cn), mask, clab, anchor, bound)
    stats = torch.empty((lc, 16), dtype=torch.float32, device=cuda)
    k_lab, k_cnt = kernels.compact_sweep_cuda(*args, stats_out=stats, **kw)
    p_lab, p_cnt = compact_sweep_reference(*args, **kw)
    want = compact_slot_stats(_cols(pos), _cols(cn), clab, anchor, bound,
                              lc=lc, w=w, th_anchor_cos=0.3, anchor_gate=True)
    assert int(stats[:, 0].sum()) == int((clab < bound).sum())
    assert 0 < float(stats[:, 8].sum()) < float(stats[:, 0].sum())
    assert torch.equal(stats, want)
    assert torch.equal(k_lab, p_lab) and torch.equal(k_cnt, p_cnt)


@pytest.mark.parametrize("case", _FOLD_CASES + ("config5_rows",))
def test_payload_moment_sums_fold_matches_plain(cuda, case):
    """#11 on the stage-then-fold hard cases, and at config 5's 1,179,648
    rows (the reduce over 1,152 block partials, one id in every block):
    sums and moments equal the plain version's bit for bit."""
    rng = np.random.default_rng(43)
    n = 1_179_648 if case == "config5_rows" else 7000
    cap = 4096
    n_live = cap if case == "full_table" else 300
    bound = kernels.ceil128(n_live)
    dead = np.array([-1, bound, -7, cap + 5])
    ids = _fold_ids(case, n, bound, 0, dead, rng)
    if case == "config5_rows":
        ids[::50] = 0
    pos = rng.uniform(0, 3e4, (n, 3)).astype(np.float32)
    pay = np.concatenate([np.ones((n, 1)), _unit_rows(rng, n), pos,
                          (pos * pos).sum(1)[:, None]], 1).astype(np.float32)
    q = rng.uniform(0, 3e4, (n_live - 20, 3)).astype(np.float32)
    ids_t, pay_t, q_t = (torch.from_numpy(a).to(cuda) for a in (ids, pay, q))
    got = kernels.payload_moment_sums_cuda(ids_t, pay_t, q_t, n_live,
                                           table_cap=cap)
    ref = payload_moment_sums_reference(ids_t, pay_t, q_t, n_live,
                                        table_cap=cap)
    live = (ids >= 0) & (ids < bound)
    assert int(got[0][:, 0].sum()) == int(live.sum())
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_estimate_normals_window_card_matches_cpu(scene):
    """#3 in radius-only mode under ``estimate_normals_window``: the card's
    moments are the kernel's (launched), equal to the plain version's bit
    for bit, and the normals follow the CPU path's within its moments'
    reordering (the same rows; |n·n'| ≥ 1 − 1e-4 on 99% of them)."""
    from buildingsegment_tpu_torch.ops.normals import estimate_normals_window

    pos, _nrm, mask = scene
    kernels.reset_launch_counts()
    n_card, c_card = estimate_normals_window(pos, mask, radius=100.0,
                                             window=64)
    assert kernels.launch_counts["stats_sweep"] == 1
    n_cpu, c_cpu = estimate_normals_window(pos.cpu(), mask.cpu(),
                                           radius=100.0, window=64)
    dots = (n_card.cpu() * n_cpu).sum(1).abs()[mask.cpu()]
    assert float(torch.quantile(dots, 0.01)) >= 1 - 1e-4
    assert torch.equal(torch.isfinite(c_card).cpu(), torch.isfinite(c_cpu))


@pytest.mark.parametrize("heal", [True, "merge", False],
                         ids=["full", "merge", "none"])
def test_multigrid_heal_card_matches_cpu(cuda, heal):
    """The multigrid ``heal`` switch on the card against the CPU: #8
    launches at ``heal=False`` only (the outermost finalize's sums), and
    the labels hold the end-to-end contract."""
    from buildingsegment_tpu_torch.ops.stats_sweep import (
        knn_normals_window_stats,
    )
    from buildingsegment_tpu_torch.seg.coarse import segment_planes_multigrid

    pts, truth = make_building_cloud(**_SCENE)
    cap = 16384
    pos = np.full((cap, 3), 2**24, np.int32)
    pos[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    struth = np.full(cap, -1)
    struth[: len(pts)] = truth
    out = {}
    for dev in ("cuda", "cpu"):
        spos, smask, order = morton_sort(torch.from_numpy(pos).to(dev),
                                         torch.from_numpy(mask).to(dev), True)
        dk, nrm, curv = knn_normals_window_stats(
            spos.float(), smask, k=15, window=48, radius=100.0, max_nn=50)
        kernels.reset_launch_counts()
        seg = segment_planes_multigrid(
            spos, nrm, smask, kth_sq_dist=dk, curvature=curv, group=4,
            levels=2, max_edge_dist=600.0, heal=heal)
        if dev == "cuda":
            assert kernels.launch_counts["plane_sums"] == int(heal is False)
            assert kernels.launch_counts["plane_adopt"] == 1 + int(
                heal is True)
        out[dev] = (seg.num_planes, seg.plane_idx.cpu().numpy(),
                    order.cpu().numpy())
    (pa, la, oa), (pb, lb, ob) = out["cuda"], out["cpu"]
    assert pa == pb and np.array_equal(oa, ob)
    valid = mask[oa]
    assert bij_agreement(la[valid], lb[valid]) >= 0.99
    t = struth[oa][valid]
    assert abs(bij_agreement(t, la[valid]) - bij_agreement(t, lb[valid])) \
        < 0.01
