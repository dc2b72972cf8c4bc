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
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.compact_sweep import (
    COMPACT_L,
    compact_sweep_reference,
)
from buildingsegment_tpu_torch.ops.fused import knn_normals_window_sorted
from buildingsegment_tpu_torch.ops.normals import canonicalize_normals
from buildingsegment_tpu_torch.ops.window_sweep import label_sweep_reference
from buildingsegment_tpu_torch.pipeline import (
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


def test_segment_cloud_card_matches_cpu(cuda):
    pts, truth = make_building_cloud(**_SCENE)
    cfg = PipelineConfig(knn_method="window", seg_group=1,
                         pad_to_multiple=2048)
    kernels.reset_launch_counts()
    a = segment_cloud(HostPointCloud(positions=pts), cfg, device="cuda")
    assert all(v > 0 for v in kernels.launch_counts.values())
    b = segment_cloud(HostPointCloud(positions=pts), cfg, device="cpu")
    assert a.num_planes == b.num_planes
    assert bij_agreement(a.plane_idx, b.plane_idx) >= 0.99
    assert abs(bij_agreement(truth, a.plane_idx)
               - bij_agreement(truth, b.plane_idx)) < 0.01
