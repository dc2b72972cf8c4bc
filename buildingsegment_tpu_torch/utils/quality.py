"""Segmentation-quality metrics (the port's copy of
``buildingsegment_tpu/utils/quality.py``).

The core metric is greedy bijective label agreement: the fraction of
points whose (truth, predicted) label pair survives a greedy one-to-one
matching of truth labels to predicted labels by pair frequency.  It is
permutation-invariant (plane ids are arbitrary on both sides) and
penalizes both splits and merges — the practical form of the BASELINE
north-star "per-point label parity" metric for synthetic scenes whose
ground-truth decomposition is known (SURVEY.md §4 "golden end-to-end").
"""

from __future__ import annotations

import numpy as np

__all__ = ["bij_agreement"]


def bij_agreement(truth: np.ndarray, pred: np.ndarray) -> float:
    """Greedy bijective per-point label agreement in [0, 1].

    Vectorized over points (the pair table is built with one
    ``np.unique``; only the tiny pair table is looped), so it is cheap
    even at 1M+ points — usable inside the benchmark harness.

    Args:
        truth: int[N] ground-truth plane ids (any coding).
        pred: int[N] predicted plane ids (any coding; e.g. 1..P / −1).

    Returns:
        matched points / N under the greedy 1:1 label matching
        (ties broken by larger pair count first, then pair order).
    """
    truth = np.asarray(truth).ravel()
    pred = np.asarray(pred).ravel()
    if truth.shape != pred.shape:
        raise ValueError(f"shape mismatch {truth.shape} vs {pred.shape}")
    n = truth.size
    if n == 0:
        return 1.0
    key = (truth.astype(np.int64) << 32) | (
        pred.astype(np.int64) & 0xFFFFFFFF
    )
    pairs, counts = np.unique(key, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    used_a, used_b, good = set(), set(), 0
    for p, c in zip(pairs[order].tolist(), counts[order].tolist()):
        a = p >> 32
        b = p & 0xFFFFFFFF
        if b >= 1 << 31:  # recover the signed low word (e.g. −1)
            b -= 1 << 32
        if a in used_a or b in used_b:
            continue
        used_a.add(a)
        used_b.add(b)
        good += c
    return good / n
