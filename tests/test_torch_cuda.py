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
    table_lookup_reference,
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


@pytest.mark.parametrize("anchor_gate", [True, False])
def test_compact_sweep_kernel_matches_plain(scene, anchor_gate):
    """Three chained sweeps from a singleton slot state: labels and
    counters equal at every step (the per-slot sums run in the same
    fixed order in both versions)."""
    pos, nrm, mask = scene
    n, w, lc = mask.shape[0], 16, COMPACT_L
    cn = canonicalize_normals(nrm)
    g = torch.Generator(device="cpu").manual_seed(4)
    live = mask & (torch.rand(n, generator=g).to(pos.device) < 0.2)
    clab = torch.where(live, torch.cumsum(live, 0) - 1, lc).to(torch.int32)
    bound = int(live.sum())
    assert bound <= lc
    anchor = torch.zeros((lc, 3), device=pos.device)
    anchor[clab[live].long()] = cn[live]
    cols = lambda t: [t[:, d].contiguous() for d in range(3)]
    kw = dict(lc=lc, w=w, th_thickness=TH, th_normal_cos=CTH,
              edge_gate2=EDGE ** 2, root_gate=EDGE,
              th_anchor_cos=0.95 if anchor_gate else 0.0,
              anchor_gate=anchor_gate)
    for _ in range(3):
        args = (cols(pos), cols(nrm), cols(cn), mask, clab, anchor, bound)
        k_lab, k_cnt = kernels.compact_sweep_cuda(*args, **kw)
        p_lab, p_cnt = compact_sweep_reference(*args, **kw)
        assert torch.equal(k_lab, p_lab)
        assert torch.equal(k_cnt, p_cnt) and int(k_cnt[0]) > 0
        clab, bound = k_lab, min(int(k_cnt[1]) + 1, bound)


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


@pytest.mark.parametrize(
    "cfg,launched",
    [
        (PipelineConfig(knn_method="window", seg_group=1,
                        pad_to_multiple=2048), _SLICE1),
        (PipelineConfig(knn_method="window"), _MULTIGRID),
        (PipelineConfig(knn_method="brute"), ()),
        (PipelineConfig(knn_method="pallas"), _PALLAS),
    ],
    ids=["single_level", "default_multigrid", "brute", "pallas"],
)
def test_segment_cloud_card_matches_cpu(cuda, cfg, launched):
    pts, truth = make_building_cloud(**_SCENE)
    kernels.reset_launch_counts()
    a = segment_cloud(HostPointCloud(positions=pts), cfg, device="cuda")
    assert all(kernels.launch_counts[k] > 0 for k in launched), \
        kernels.launch_counts
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


def _plane_problem(pos, nrm, mask, seed):
    """Plane ids by row blocks (some dropped) and their fitted table."""
    n = mask.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.arange(n, device=pos.device)
    pid = (rows // 300 % 9 + 1).to(torch.int32)
    drop = torch.rand(n, generator=g).to(pos.device) < 0.3
    pid = torch.where(drop | ~mask, 0, pid).to(torch.int32)
    p = 64
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


def test_table_lookup_kernel_matches_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(8)
    ids = torch.randint(-3, 700, (50_000,), generator=g, dtype=torch.int32)
    lut = torch.randint(0, 500, (600,), generator=g, dtype=torch.int32)
    for n_live in (130, 600, 5000):
        got = kernels.table_lookup_cuda(ids.to(cuda), lut.to(cuda), n_live)
        ref = table_lookup_reference(ids, lut, n_live)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("cols", [1, 8])
def test_plane_sums_kernel_matches_plain(cuda, cols):
    """#8 against its plain version, on the card and on the CPU, bit for
    bit: ids over a 300-row table with dead ones (negative, above the
    live bound), 50,000 rows (not a multiple of the 1,024-row blocks)."""
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


def _knn_cloud(case, device):
    """(positions int32[C, 3], mask bool[C]) on ``device``: a random
    cloud or the small scene, Morton-sorted, or an unsorted cloud whose
    last third is padding."""
    rng = np.random.default_rng(12)
    if case == "random":
        pts, cap = rng.integers(0, 20_000, (8000, 3)), 8192
    elif case == "scene":
        pts, cap = make_building_cloud(**_SCENE)[0], 9216
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


@pytest.mark.parametrize("case,k", [("random", 16), ("scene", 16),
                                    ("scene", 50), ("padding", 16)])
def test_knn_exact_kernel_matches_plain(cuda, case, k):
    pos, mask = _knn_cloud(case, cuda)
    cols, seed_d, seed_i, visit, visit_d2, counts, qt, ct, w = _prepare(
        pos, mask, k)
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
