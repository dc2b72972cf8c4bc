"""Kernel #3, the fused stats sweep (``csrc/stats_sweep.cu``)."""

from benchmark.roofline.common import nbytes, window_pairs

ENTRY = "stats_sweep_cuda"


def work(args, kw, out):
    """Per pair of the ±w window: d² (8), the radius ∩ cap test (1) and
    one compare for each order statistic the call selects (the k-th NN
    when k > 1, the hybrid cap when max_nn − 1 < 2w); per neighbour used:
    the moments (19)."""
    mask = args[1]
    outs = out if isinstance(out, tuple) else (out,)
    moved = nbytes(args) + nbytes(outs)
    pairs = window_pairs(mask, kw["w"])
    used = float((out[1] - mask.float()).sum())
    stats = int(kw["k"] > 1) + int(
        kw["max_nn"] is not None and kw["max_nn"] - 1 < 2 * kw["w"])
    return moved, pairs * (8 + 1 + stats) + used * 19
