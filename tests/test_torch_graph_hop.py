"""The graph solve's edge walk (``ops/graph_hop``): the plain versions of
the hop and the union hook against a per-edge loop of the same gates in
float32, on small graphs; the edge gate of ``graph_edges``; and the
solve's calls of the two dispatchers.  ``csrc/graph_hop.cu`` is held
against the same plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from buildingsegment_tpu_torch.ops import graph_hop as gh
from buildingsegment_tpu_torch.seg import region_grow

TH, CTH = 300.0, 0.88
F32_CTH = np.float32(CTH)


def _unit(rng, n, spread):
    v = np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, spread, (n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _random_case(rng, *, n=48, kk=7, labels="random", self_share=0.1,
                 mask_share=0.1, gate=None):
    pos = rng.uniform(0.0, 900.0, (n, 3)).astype(np.float32)
    nrm = _unit(rng, n, 0.35)
    nb = rng.integers(0, n, (n, kk + 1))
    nb[:, 0] = np.arange(n)
    selfs = rng.random((n, kk)) < self_share
    nb[:, 1:][selfs] = np.broadcast_to(np.arange(n)[:, None], (n, kk))[selfs]
    mask = rng.random(n) >= mask_share
    d2 = None
    if gate is not None:
        diff = pos[nb] - pos[:, None, :]
        d2 = (diff * diff).sum(-1).astype(np.float32)
    ng = n
    if labels == "ties":
        lab = rng.choice([0, 3, 7, ng], n)
    elif labels == "inf":
        lab = np.where(rng.random(n) < 0.7, ng, rng.integers(0, ng, n))
    else:
        lab = rng.integers(0, ng + 1, n)
    model_n = _unit(rng, ng, 0.3)
    model_c = (pos[rng.integers(0, n, ng)]
               + rng.normal(0.0, 150.0, (ng, 3))).astype(np.float32)
    return pos, nrm, nb, mask, d2, gate, lab.astype(np.int32), model_n, model_c


def _threshold_case():
    """Point 0 (label 0, model (1, 0, 0) at the origin) and its edges to
    points at d = 300 and c = float32(0.88) exactly, one float beyond
    each, a flipped normal, a NaN position, and a point behind the
    plane; every other point lists only itself."""
    f = np.float32
    y = f(np.sqrt(1.0 - float(F32_CTH) ** 2))
    pos = np.array([
        [0, 0, 0], [300, 5, 7], [np.nextafter(f(300), f(1e9)), 5, 7],
        [300, 5, 7], [300, 5, 7], [np.nan, 0, 0], [-300, 1, 2],
    ], np.float32)
    nrm = np.array([
        [1, 0, 0], [F32_CTH, y, 0], [F32_CTH, y, 0],
        [np.nextafter(F32_CTH, f(0)), y, 0], [-F32_CTH, y, 0],
        [1, 0, 0], [1, 0, 0],
    ], np.float32)
    n = pos.shape[0]
    nb = np.repeat(np.arange(n)[:, None], n, 1)
    nb[0] = np.arange(n)
    mask = np.ones(n, bool)
    lab = np.arange(n, dtype=np.int32)
    # each label's model is its point's normal and position
    return pos, nrm, nb, mask, None, None, lab, nrm.copy(), pos.copy()


CASES = {
    "random": lambda rng: _random_case(rng),
    "ties": lambda rng: _random_case(rng, labels="ties"),
    "inf_labels": lambda rng: _random_case(rng, labels="inf"),
    "self_and_invalid": lambda rng: _random_case(rng, self_share=0.4,
                                                 mask_share=0.3),
    "edge_gate": lambda rng: _random_case(rng, gate=400.0),
    "exact_thresholds": lambda rng: _threshold_case(),
}


def _accepts(model_n, model_c, p, q, lbl, signed):
    """The gate, one edge at a time, in float32 scalars."""
    if lbl >= model_n.shape[0]:
        return False
    mn, mc = model_n[lbl], model_c[lbl]
    d = abs((p[0] - mc[0]) * mn[0] + (p[1] - mc[1]) * mn[1]
            + (p[2] - mc[2]) * mn[2])
    c = q[0] * mn[0] + q[1] * mn[1] + q[2] * mn[2]
    if not signed:
        c = abs(c)
    return bool(d <= np.float32(TH)) and bool(c >= F32_CTH)


def _loop_edges(nb, mask, d2, gate):
    n, kk = nb.shape[0], nb.shape[1] - 1
    valid = np.zeros((n, kk), bool)
    for i in range(n):
        for s in range(kk):
            t = nb[i, s + 1]
            ok = mask[i] and mask[t] and t != i
            if gate is not None:
                ok = ok and d2[i, s + 1] <= np.float32(gate) * np.float32(gate)
            valid[i, s] = ok
    return valid


def _loop_hop(lab, nb, valid, pos, nrm, model_n, model_c, signed):
    out = lab.copy()
    for i in range(lab.shape[0]):
        for s in range(valid.shape[1]):
            if not valid[i, s]:
                continue
            t = nb[i, s + 1]
            if _accepts(model_n, model_c, pos[i], nrm[i], lab[t], signed):
                out[i] = min(out[i], lab[t])
            if _accepts(model_n, model_c, pos[t], nrm[t], lab[i], signed):
                out[t] = min(out[t], lab[i])
    return out


def _loop_union(lab, nb, valid, model_n, model_c, signed):
    ng = model_n.shape[0]
    parent = np.arange(ng, dtype=np.int32)
    for i in range(lab.shape[0]):
        for s in range(valid.shape[1]):
            la, lb = lab[i], lab[nb[i, s + 1]]
            if not valid[i, s] or la >= ng or lb >= ng or la == lb:
                continue
            if (_accepts(model_n, model_c, model_c[lb], model_n[lb], la,
                         signed)
                    and _accepts(model_n, model_c, model_c[la], model_n[la],
                                 lb, signed)):
                hi, lo = max(la, lb), min(la, lb)
                parent[hi] = min(parent[hi], lo)
    return parent


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_walk_matches_edge_loop(case, signed):
    rng = np.random.default_rng(sorted(CASES).index(case) * 2 + signed)
    pos, nrm, nb_full, mask, d2, gate, lab, model_n, model_c = CASES[case](rng)
    t = torch.from_numpy
    nb, nb_valid = gh.graph_edges(
        t(nb_full).int(), t(mask), None if d2 is None else t(d2), gate)
    assert nb.dtype == torch.int32 and nb.is_contiguous()
    valid = _loop_edges(nb_full, mask, d2, gate)
    assert np.array_equal(nb_valid.numpy(), valid)
    points = gh.graph_points(t(pos), t(nrm))
    models = gh.model_table(t(model_n), t(model_c))
    assert points.shape == (pos.shape[0], 8) and models.shape[1] == 8
    kw = dict(th_thickness=TH, th_normal_cos=CTH, signed=signed)

    hop = gh.graph_hop(t(lab), nb, nb_valid, points, models, **kw)
    want = _loop_hop(lab, nb_full, valid, pos, nrm, model_n, model_c, signed)
    assert hop.dtype == torch.int32
    assert np.array_equal(hop.numpy(), want)
    assert torch.equal(hop, gh.graph_hop_reference(
        t(lab), nb, nb_valid, points, models, **kw))

    parent = gh.graph_union_hooks(t(lab), nb, nb_valid, models, **kw)
    want_p = _loop_union(lab, nb_full, valid, model_n, model_c, signed)
    assert parent.dtype == torch.int32
    assert np.array_equal(parent.numpy(), want_p)

    if case == "exact_thresholds":
        # d = 300 and c = float32(0.88) pass; one float beyond fails; the
        # flipped normal passes unless signed; NaN fails; behind passes
        assert hop.tolist() == [0, 0, 2, 3, 4 if signed else 0, 5, 0]
        assert parent[1] == 0 and parent[2] == 2 and parent[5] == 5
        assert parent[4] == (4 if signed else 0)


def test_solve_calls_the_walk_once_a_hop_and_once_a_union(monkeypatch):
    """A graph solve calls the hop GRAPH_HOPS times a sweep and the union
    once a sweep (the card's launch counts follow)."""
    rng = np.random.default_rng(3)
    n, k = 300, 8
    pos = np.zeros((n, 3), np.float32)
    pos[:, :2] = rng.uniform(0.0, 3000.0, (n, 2))
    pos[:, 2] = rng.normal(0.0, 5.0, n)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    calls = {"hop": 0, "union": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(region_grow, "graph_hop",
                        counted("hop", gh.graph_hop))
    monkeypatch.setattr(region_grow, "graph_union_hooks",
                        counted("union", gh.graph_union_hooks))
    seg = region_grow.segment_planes(
        torch.from_numpy(pos), torch.from_numpy(nrm),
        torch.from_numpy(idx).int(), torch.ones(n, dtype=torch.bool),
        th_point_count=10, propagation="graph")
    assert seg.num_sweeps >= 1 and seg.num_planes >= 1
    assert calls == {"hop": region_grow.GRAPH_HOPS * seg.num_sweeps,
                     "union": seg.num_sweeps}
