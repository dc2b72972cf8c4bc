"""The window-only design of the block-form stats sweep (#15), on the CPU.

``csrc/stats_mxu.cu`` ranks and gates only each query's 2w + 1 window
slots, where the block form (``ops.stats_mxu.stats_mxu_reference``, the
TPU kernel ``_stats_mxu_kernel``) ranks all C = 128 + 2w candidates of
the query's block: every rank value outside the window or at self is
clamp(D) + 1e30, so only a window slot can rank below the 1e29 mask cut.
``window_form`` below rebuilds that design in plain PyTorch:

  * dk: the (k−1)-th smallest of the 2w window values, self excluded,
    +inf past them, 0 from 1e29's bits up;
  * the cap: it binds only where cnt_r, the window values ≤ r², reaches
    max_nn − 1; then r_eff² = min(r², (max_nn−1)-th window value), else
    r²;
  * the moments: the 2w + 1 slots (self included) with clamp(D) ≤ r_eff²,
    added in candidate order.

It is held bit for bit against ``stats_mxu_reference`` and, at small span
(coordinates < 256, every intermediate an exact f32 integer), against the
JAX ``fused_stats_mxu`` run in interpret mode.  Inputs are made with
numpy from a seed: 2,048 rows (16 query blocks), Morton-sorted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buildingsegment_tpu.ops.stats_mxu import fused_stats_mxu
from buildingsegment_tpu.ops.window_sweep import make_slab
from buildingsegment_tpu_torch.core.morton import morton_sort
from buildingsegment_tpu_torch.ops.stats_mxu import (
    BIG_CUT_BITS,
    MXU_BLOCK,
    _gather_blocks,
    _origin,
    mxu_r2,
    mxu_ranks,
    stats_mxu_reference,
)

CAP, TILE = 2048, 1024
RADIUS = 40.0
_BIG = 1e30


def window_form(pos, mask, *, k, w, radius, max_nn):
    """The window-only design of ``csrc/stats_mxu.cu`` in plain PyTorch:
    (dk, s0, s1, s2) as ``stats_mxu_reference`` returns them."""
    n = mask.shape[0]
    nb = -(-n // MXU_BLOCK)
    r_k, r_cap = mxu_ranks(k, w, max_nn)
    r2 = mxu_r2(radius)
    cx, cy, cz, cv = _gather_blocks([*pos, mask], [-3e7] * 3 + [False], w,
                                    0, nb)
    ox, oy, oz = _origin(cx, cy, cz, cv)
    cxo, cyo, czo = cx - ox, cy - oy, cz - oz
    c2 = cxo * cxo + cyo * cyo + czo * czo
    bigc = torch.where(cv, 0.0, _BIG)
    # query q's slots: candidates q + j of its block, offset j − w
    slots = (torch.arange(MXU_BLOCK)[:, None]
             + torch.arange(2 * w + 1)[None, :])
    q = slice(w, w + MXU_BLOCK)

    def at(a):  # [nb, 128, 2w + 1] candidate values at the slots
        return a[:, slots]

    def query(a):  # [nb, 128, 1] the query's own value
        return a[:, q, None]

    qxo, qyo, qzo = query(cxo), query(cyo), query(czo)
    d = at(cxo) * (-2.0 * qxo)
    d = d + at(cyo) * (-2.0 * qyo)
    d = d + at(czo) * (-2.0 * qzo)
    d = d + at(c2)
    d = d + query(c2)
    d = d + at(bigc)
    d = torch.clamp_min(d + query(bigc), 0.0)
    ranked = torch.cat([d[..., :w], d[..., w + 1:]], -1)  # self excluded
    srt = torch.sort(ranked, -1).values
    srt = torch.cat([srt, torch.full_like(srt[..., :1], float("inf"))
                     .expand(*srt.shape[:-1], max(r_k, r_cap, 1))], -1)

    def rank(r):  # the r-th smallest window value, +inf past them
        return srt[..., r - 1]

    dk = rank(r_k) if r_k else torch.zeros_like(d[..., 0])
    dk = torch.where(dk.view(torch.int32) >= BIG_CUT_BITS, 0.0, dk)
    r_eff2 = torch.full_like(dk, r2)
    if r_cap:
        binds = (ranked <= r2).sum(-1) >= r_cap
        r_eff2 = torch.where(binds, torch.minimum(r_eff2, rank(r_cap)),
                             r_eff2)
    gate = d <= r_eff2[..., None]
    a, b, e = at(cxo), at(cyo), at(czo)
    terms = [torch.ones_like(a), a, b, e, a * a, b * b, e * e, a * b, a * e,
             b * e]
    m = [torch.zeros_like(dk) for _ in terms]
    for j in range(2 * w + 1):  # candidate order
        g = gate[..., j]
        m = [torch.where(g, s + t[..., j], s) for s, t in zip(m, terms)]
    qx, qy, qz = qxo[..., 0], qyo[..., 0], qzo[..., 0]
    n_, sx, sy, sz = m[0], m[1], m[2], m[3]
    sxx = m[4] - 2.0 * qx * sx + n_ * qx * qx
    syy = m[5] - 2.0 * qy * sy + n_ * qy * qy
    szz = m[6] - 2.0 * qz * sz + n_ * qz * qz
    sxy = m[7] - qx * sy - qy * sx + n_ * qx * qy
    sxz = m[8] - qx * sz - qz * sx + n_ * qx * qz
    syz = m[9] - qy * sz - qz * sy + n_ * qy * qz
    out = torch.stack([dk, n_, sx - n_ * qx, sy - n_ * qy, sz - n_ * qz,
                       sxx, syy, szz, sxy, sxz, syz]).reshape(11, -1)[:, :n]
    return out[0], out[1], out[2:5].T, out[5:11].T


def _cloud(case):
    """(pos f32[CAP, 3], mask bool[CAP]) Morton-sorted, coordinates < 256
    but for "fractions":

    * random: 1,500 points uniform in [0, 250)³;
    * sparse: 400 points scattered over the 2,048 rows (invalid rows
      inside every window; blocks 8–15 hold no valid row, origin 0);
    * ties: a 12³ integer grid 4 apart, so most distances tie;
    * origin_dups: 40 copies of (0, 0, 0) (the block origin, where D's
      partial sums are −0 before |c−o|² makes them +0) and 30 copies of
      two more points, among 800 random ones;
    * fractions: "random" moved to 5,000 + x with a random fraction on
      every coordinate (not small span: D and the moments round, so the
      order of every sum shows in the bits).
    """
    rng = np.random.default_rng({"random": 0, "sparse": 1, "ties": 2,
                                 "origin_dups": 3, "fractions": 4}[case])
    pos = np.full((CAP, 3), 2**24, np.int32)
    mask = np.zeros(CAP, bool)
    if case == "sparse":
        sel = rng.choice(CAP, 400, replace=False)
        pos[sel] = rng.integers(0, 200, (400, 3))
        mask[sel] = True
    else:
        if case in ("random", "fractions"):
            pts = rng.integers(0, 250, (1500, 3))
        elif case == "ties":
            g = np.arange(12) * 4
            pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
            pts = pts.reshape(-1, 3)
        else:
            pts = np.concatenate([
                np.zeros((40, 3), np.int64),
                np.repeat(np.array([[3, 0, 0], [0, 5, 7]]), 30, 0),
                rng.integers(0, 120, (800, 3))])
        pos[:len(pts)] = pts
        mask[:len(pts)] = True
    spos, smask, _ = morton_sort(torch.from_numpy(pos),
                                 torch.from_numpy(mask), True)
    if case == "sparse":
        assert not smask[1024:].any()
    spos = spos.float().numpy()
    if case == "fractions":
        spos = (spos + 5000.0 + rng.random(spos.shape)).astype(np.float32)
    return spos, smask.numpy()


def _cols(spos):
    return tuple(torch.from_numpy(np.ascontiguousarray(spos[:, d]))
                 for d in range(3))


def _assert_bits(got, want, what):
    for g, r, name in zip(got, want, ("dk", "s0", "s1", "s2")):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32),
                                      err_msg=f"{name} vs {what}")


_CASES = ("random", "sparse", "ties", "origin_dups")


@pytest.mark.parametrize("case", _CASES + ("fractions",))
@pytest.mark.parametrize("w", [16, 48])
@pytest.mark.parametrize("deep_k", [False, True])
@pytest.mark.parametrize("cap", ["none", "below_2w", "at_2w"])
def test_window_form_matches_block_form(case, w, deep_k, cap):
    """The window-only design equals the block form's plain version bit
    for bit: k − 1 = 14 (≤ 16) or 2w + 4 (past the window: dk = 0),
    max_nn None, 20 (< 2w) or 2w (the cap at the window's last value)."""
    spos, smask = _cloud(case)
    kw = dict(k=2 * w + 5 if deep_k else 15, w=w, radius=RADIUS,
              max_nn={"none": None, "below_2w": 20, "at_2w": 2 * w}[cap])
    pos, mask = _cols(spos), torch.from_numpy(smask)
    want = stats_mxu_reference(pos, mask, **kw)
    got = window_form(pos, mask, **kw)
    _assert_bits([g.numpy() for g in got], [r.numpy() for r in want],
                 "stats_mxu_reference")
    if deep_k:
        assert not want[0].any()
    else:
        assert (want[0] > 0).sum() > 100
    assert (want[1] > 1).sum() > 100
    if case == "origin_dups":  # ties at 0: dk is +0, never −0
        zero = smask & (want[0].numpy() == 0)
        assert zero.sum() >= 40
        assert not np.signbit(want[0].numpy()[zero]).any()


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("w,k,max_nn", [(16, 15, 20), (48, 15, 20),
                                        (16, 37, None), (48, 15, 96)])
def test_window_form_matches_jax_small_span(case, w, k, max_nn):
    """At small span the window-only design equals the JAX kernel run in
    interpret mode, bit for bit."""
    spos, smask = _cloud(case)
    kw = dict(k=k, w=w, radius=RADIUS, max_nn=max_nn)
    slab = make_slab(
        [jnp.asarray(spos[:, d]) for d in range(3)]
        + [jnp.asarray(smask.astype(np.float32))],
        [-3e7, -3e7, -3e7, 0.0], w, TILE, rows_out=8,
    )
    want = fused_stats_mxu(slab, CAP, tile=TILE, interpret=True, **kw)
    got = window_form(_cols(spos), torch.from_numpy(smask), **kw)
    _assert_bits([g.numpy() for g in got], want, "fused_stats_mxu")
